"""The control: the reference computed one precision below the served
bfloat16, every product's inputs in float8 (e4m3): each weight matrix on
a scale of its own, each activation row on its own, the product taken in
float32 from those values.  The router, the attention and the norms stay
in float32, as a float8 serving path keeps them.  A comparison that
cannot tell this from the program cannot hold the program to bfloat16."""

from __future__ import annotations

import torch

from .model import Reference

E4M3_MAX = 448.0


def fp8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 on an amax scale (per tensor, or per
    slice along ``dim``), back in float32."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = E4M3_MAX / amax.clamp(min=1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Fp8Reference(Reference):
    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fp8(x, dim=-1) @ fp8(w)
