"""Model definitions of the port (every architecture of the JAX package).

  common       ParamSpec trees, initializers (explicit torch.Generator)
  layers       norms, RoPE and M-RoPE, GQA attention (dense/chunked, flash
               VJP), SwiGLU and GELU MLPs
  blocks       every block kind's params/apply + cache geometry, paged decode
  moe, ssm,    the MoE FFN, the Mamba mixer, the mLSTM / sLSTM blocks
  xlstm
  transformer  LM and encoder-decoder assembly, layer loops, forward_train,
               prefill/decode
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
