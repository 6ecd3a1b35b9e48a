"""The plain reference of the served models: float32 PyTorch with TF32 off,
no kernels, no cache, no batching.  Imports nothing of ``repro_torch``,
``repro`` or ``jax``."""
