"""Mamba-1 selective SSM with a chunked selective scan.

Port of ``repro/models/ssm.py``.  The recurrence is

    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + dt_t ⊙ B_t ⊙ x_t        (h: [d_inner, N])
    y_t = ⟨h_t, C_t⟩_N + D ⊙ x_t

:func:`selective_scan_ref` runs it step by step (the oracle of the tests).
:func:`selective_scan` processes the sequence in chunks of ``chunk_size``
(the tail padded with ``dt = 0``: an identity step with no input) and
carries only the [B, d_inner, N] boundary state across chunks.  Inside a
chunk the JAX package runs ``jax.lax.associative_scan``; here a log-depth
doubling scan over the chunk axis does the same job with the same combine,
``(a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2)``.  The state stays fp32, as
in the reference; a chunk is [B, chunk, d_inner, N] fp32.  No kernel: the
JAX package reaches no ``pallas_call`` here either.

Tensor-parallel (a ``Shard`` of ``ssm_inner`` over ``model``): each rank
holds its channels of ``in_proj``'s two halves' columns, ``conv_w``,
``conv_b``, ``dt_bias``, ``A_log``, ``D``, ``dt_proj``'s columns, the rows
of ``x_proj`` and ``out_proj``, and of the states.  The conv and the scan
are per channel and run on the rank's own; ``x_c @ x_proj`` and
``y @ out_proj`` are partial products, summed (``distributed/
tensor_parallel.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import dataclasses

import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import Shard, all_gather, all_reduce_sum, to_local_region
from .common import ParamSpec, fan_in_init, normal_init, ones_init, zeros_init


# ------------------------------------------------------------------ the scan


def selective_scan_ref(x, dt, B, C, A, D, h0=None):
    """Sequential oracle.  x,dt: [b,s,d]; B,C: [b,s,n]; A: [d,n]; D: [d]."""
    b, s, d = x.shape
    n = B.shape[-1]
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t, :, None] * A)              # [b,d,n]
        dBx = dtf[:, t, :, None] * Bf[:, t, None, :] * xf[:, t, :, None]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + D * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, d))
    return y.to(x.dtype), h


def _scan_chunk(a, bx):
    """Inclusive scan of ``(a, bx)`` along dim 1 under the first-order
    recurrence combine, by doubling: after the round of offset ``k`` each
    position holds the combine of the ``2k`` positions ending at it."""
    k = 1
    while k < a.shape[1]:
        a_prev, b_prev = a[:, :-k], bx[:, :-k]
        bx = torch.cat([bx[:, :k], a[:, k:] * b_prev + bx[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a_prev], dim=1)
        k *= 2
    return a, bx


def selective_scan(x, dt, B, C, A, D, h0=None, chunk_size: int = 128):
    """Chunked selective scan; matches :func:`selective_scan_ref`.

    Returns (y [b,s,d], h_last [b,d,n]).
    """
    b, s, d = x.shape
    n = B.shape[-1]
    cs = min(chunk_size, s)
    if s % cs != 0:  # pad tail with dt=0 (identity transition, no input)
        pad = cs - s % cs
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s_pad = x.shape[1]
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for c0 in range(0, s_pad, cs):
        x_c = x[:, c0:c0 + cs].float()
        dt_c = dt[:, c0:c0 + cs].float()
        B_c = B[:, c0:c0 + cs].float()
        C_c = C[:, c0:c0 + cs].float()
        logA = dt_c[..., None] * A                          # [b,cs,d,n] (<= 0)
        dBx = dt_c[..., None] * B_c[:, :, None, :] * x_c[..., None]
        cumA, cumB = _scan_chunk(torch.exp(logA), dBx)
        h_t = cumA * h[:, None] + cumB                      # [b,cs,d,n]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_t, C_c))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1)[:, :s]
    return (y + D * x[:, :s].float()).to(x.dtype), h


def selective_scan_decode(x, dt, B, C, A, D, h):
    """One-token update.  x,dt: [b,d]; B,C: [b,n]; h: [b,d,n]."""
    xf = x.float()
    dtf = dt.float()
    dA = torch.exp(dtf[..., None] * A)
    h = dA * h + dtf[..., None] * B.float()[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, C.float()) + D * xf
    return y.to(x.dtype), h


# ----------------------------------------------------------------- conv1d


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: [b,s,d]; w: [K,d]; state: [b,K-1,d].

    Returns (y [b,s,d], new_state [b,K-1,d]).
    """
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)           # [b, s+K-1, d]
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):  # K is 4: unrolled shifts, as the reference
        y = y + xp[:, k:k + s].float() * w[k].float()
    y = y + bias.float()
    return y.to(x.dtype), xp[:, s:]


# ------------------------------------------------------------- mamba block


def mamba_param_specs(d_model: int, d_inner: int, ssm_state: int,
                      d_conv: int = 4, dt_rank: Optional[int] = None) -> dict:
    dt_rank = dt_rank or max(1, d_model // 16)

    def a_log_init(gen, shape, dtype):
        del gen
        # S4D-real init: A = -[1..N] per channel
        return torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32)
                         .expand(shape)).to(dtype)

    def dt_bias_init(gen, shape, dtype):
        # softplus^-1 of dt ~ U[1e-3, 1e-1]
        u = 1e-3 + (1e-1 - 1e-3) * torch.rand(shape, generator=gen, dtype=torch.float32)
        return torch.log(torch.expm1(u)).to(dtype)

    return {
        "in_proj": ParamSpec((d_model, 2 * d_inner), ("embed", "ssm_inner"), fan_in_init),
        "conv_w": ParamSpec((d_conv, d_inner), ("conv", "ssm_inner"),
                            lambda g, s, d: normal_init(g, s, d, 0.1)),
        "conv_b": ParamSpec((d_inner,), ("ssm_inner",), zeros_init),
        "x_proj": ParamSpec((d_inner, dt_rank + 2 * ssm_state), ("ssm_inner", None), fan_in_init),
        "dt_proj": ParamSpec((dt_rank, d_inner), (None, "ssm_inner"),
                             lambda g, s, d: normal_init(g, s, d, dt_rank**-0.5)),
        "dt_bias": ParamSpec((d_inner,), ("ssm_inner",), dt_bias_init),
        "A_log": ParamSpec((d_inner, ssm_state), ("ssm_inner", "ssm_state"), a_log_init),
        "D": ParamSpec((d_inner,), ("ssm_inner",), ones_init),
        "out_proj": ParamSpec((d_inner, d_model), ("ssm_inner", "embed"), fan_in_init),
    }


def split_in_proj(x: torch.Tensor, w: torch.Tensor, shard: Optional[Shard]):
    """x [.., d_model] @ w [d_model, 2·d_inner] -> its two halves [..,
    d_inner] at this rank's channels (Mamba's ``in_proj``: ``x_in``, ``z``;
    the mLSTM's ``up_proj``: ``u``, ``z``).

    Split over ``ssm_inner``, ``w`` is cut into contiguous column shards,
    which do not pair the first half with the second (over 2 ranks, rank 0
    holds all of the first and rank 1 all of the second).  So the ranks'
    products are gathered whole and each rank takes its own channels of
    both halves; ``x`` enters the column shard through
    ``to_local_region``, as the gathered product enters the rank's
    channels."""
    if shard is None or not shard.split:
        return torch.chunk(x @ w, 2, dim=-1)
    cols = dataclasses.replace(shard, offset=2 * shard.offset, size=2 * shard.size,
                               total=2 * shard.total)
    xz = to_local_region(all_gather(to_local_region(x, shard) @ w, -1, cols), shard)
    z0 = shard.total + shard.offset
    return xz[..., shard.slice], xz[..., z0:z0 + shard.size]


def _project(p: dict, x_c: torch.Tensor, dt_rank: int, shard: Optional[Shard] = None):
    """x_c [.., d_inner] -> (dt, B, C, A, D): the scan's inputs.  Split over
    ``ssm_inner``, ``x_c @ x_proj`` is a partial product: it is summed, and
    enters the rank's channels (``dt_proj``'s columns) and its scan."""
    dbc = x_c @ p["x_proj"]
    if shard is not None and shard.split:
        dbc = to_local_region(all_reduce_sum(dbc, shard), shard)
    n = p["A_log"].shape[1]
    dt, B, C = torch.split(dbc, [dt_rank, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return dt, B, C, A, p["D"].float()


def _out_proj(p: dict, y: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    out = y @ p["out_proj"]
    return out if shard is None else all_reduce_sum(out, shard)


def mamba_forward(p: dict, x: torch.Tensor, ssm_state, conv_state,
                  dt_rank: int, chunk_size: int = 128, shard: Optional[Shard] = None):
    """Full-sequence mamba mixer.  x: [b,s,d_model] (replicated over the
    mesh); ``shard``: this rank's ``ssm_inner`` channels (None: whole).

    Returns (y [b,s,d_model], (ssm_state, conv_state)), the states this
    rank's channels.
    """
    x_in, z = split_in_proj(x, p["in_proj"], shard)
    x_c, conv_state = causal_conv1d(x_in, p["conv_w"], p["conv_b"], conv_state)
    x_c = F.silu(x_c)
    dt, B, C, A, D = _project(p, x_c, dt_rank, shard)
    y, ssm_state = selective_scan(x_c, dt, B, C, A, D, ssm_state, chunk_size=chunk_size)
    y = y * F.silu(z)
    return _out_proj(p, y, shard), (ssm_state, conv_state)


def mamba_decode(p: dict, x: torch.Tensor, ssm_state, conv_state, dt_rank: int,
                 shard: Optional[Shard] = None):
    """One-token mamba step.  x: [b,1,d_model]; ``shard`` as
    :func:`mamba_forward`'s."""
    x_in, z = split_in_proj(x[:, 0], p["in_proj"], shard)
    # conv over (state ++ x): one output step
    xp = torch.cat([conv_state.to(x.dtype), x_in[:, None]], dim=1)   # [b,K,d]
    x_c = torch.einsum("bkd,kd->bd", xp.float(), p["conv_w"].float()) + p["conv_b"].float()
    x_c = F.silu(x_c).to(x.dtype)
    dt, B, C, A, D = _project(p, x_c, dt_rank, shard)
    y, ssm_state = selective_scan_decode(x_c, dt, B, C, A, D, ssm_state)
    y = y * F.silu(z)
    return _out_proj(p, y, shard)[:, None], (ssm_state, xp[:, 1:])


def mamba_state_init(batch: int, d_inner: int, ssm_state: int, d_conv: int,
                     dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros((batch, d_inner, ssm_state), dtype=torch.float32, device=device),
            torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device))
