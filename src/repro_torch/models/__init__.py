"""Model definitions of the port (dense decoder path so far).

  common       ParamSpec trees, initializers (explicit torch.Generator)
  layers       norms, RoPE, GQA attention (dense/chunked), MLPs
  blocks       dense block params/apply + cache geometry, paged decode
  transformer  LM assembly, layer loops, prefill/decode
"""

from .transformer import (  # noqa: F401
    decode_step,
    init_cache,
    init_params,
    lm_logits,
    param_specs,
    prefill,
)
