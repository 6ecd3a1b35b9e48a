"""Model definitions of the port (dense decoder path so far).

  common       ParamSpec trees, initializers (explicit torch.Generator)
  layers       norms, RoPE, GQA attention (dense/chunked, flash VJP), MLPs
  blocks       dense block params/apply + cache geometry, paged decode
  transformer  LM assembly, layer loops, forward_train, prefill/decode
"""

from .transformer import (  # noqa: F401
    decode_step,
    forward_train,
    init_cache,
    init_params,
    lm_logits,
    param_specs,
    prefill,
)
