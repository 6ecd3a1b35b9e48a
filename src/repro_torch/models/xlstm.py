"""xLSTM blocks (Beck et al., arXiv:2405.04517): mLSTM + sLSTM.

Port of ``repro/models/xlstm.py``.  mLSTM — matrix-memory LSTM with
exponential gating:

    C_t = f_t C_{t-1} + i_t v_t k_tᵀ          (C: [d_v, d_k] per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)

with log-space stabilizer m_t = max(log f_t + m_{t-1}, log i_t).  The decay
is a scalar per head, so the recurrence runs chunkwise in parallel
(:func:`mlstm_chunked`: intra-chunk matmuls, an inter-chunk [d_v, d_k]
state carry); :func:`mlstm_ref` is the sequential oracle.  sLSTM keeps a
non-linear hidden-to-gate recurrence and runs as a strict time loop
(:func:`slstm_scan`).  State, gates and stabilizers stay fp32, the
projections run in the compute dtype, as in the JAX package.

The chunk loop and the time loop write each chunk's (step's) output into
one tensor allocated before the loop, never a list that is concatenated at
the end.  The mLSTM state ``(C, n, m)`` and the sLSTM state ``(c, n, m,
h)`` are tuples here, as in the JAX package; ``models/blocks.py`` keeps
them in a layer's cache under one name each (``C``, ``n``, ...).

Tensor-parallel (under an active ``DeviceMesh``, ``distributed/
tensor_parallel.py``): the mLSTM block runs its channels on ``ssm_inner``
(a ``Shard``): ``up_proj``'s columns, the conv, the rows of ``wq wk wv
wi wf``, ``out_norm`` and the rows of ``down_proj`` are the rank's; the
five row-parallel products are summed in one collective, and the cell, its
state and the heads run whole on every rank.  The sLSTM block runs whole
but for its gated FFN, split on ``ffn`` as ``blocks.mlp_apply``'s; its
conv state, which the cache splits over ``ssm_inner`` where ``d_model``
divides, is gathered before the conv and handed back as the rank's slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.tensor_parallel import Shard, all_gather, all_reduce_sum, to_local_region
from .common import ParamSpec, fan_in_init, normal_init, ones_init, zeros_init
from .layers import rms_norm, swiglu
from .ssm import causal_conv1d, split_in_proj

LOG_EPS = -30.0


def _mlstm_state0(b, h, dv, dk, device):
    return (torch.zeros((b, h, dv, dk), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), LOG_EPS, dtype=torch.float32, device=device))


# ---------------------------------------------------------------- mLSTM core


def mlstm_ref(q, k, v, i_gate, f_gate, state=None):
    """Sequential oracle.  q,k: [b,s,h,dk]; v: [b,s,h,dv]; gates: [b,s,h].

    Returns (y [b,s,h,dv], state).  state = (C [b,h,dv,dk], n [b,h,dk],
    m [b,h]).
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    C, n, m = state if state is not None else _mlstm_state0(b, h, dv, dk, q.device)
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for t in range(s):
        q_t, k_t, v_t = q[:, t].float(), k[:, t].float(), v[:, t].float()
        i_t, f_t = i_gate[:, t].float(), f_gate[:, t].float()
        logf = F.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        fs = torch.exp(logf + m - m_new)            # stabilized forget
        istab = torch.exp(i_t - m_new)              # stabilized input
        C = fs[..., None, None] * C + istab[..., None, None] * (
            v_t[..., :, None] * k_t[..., None, :])
        n = fs[..., None] * n + istab[..., None] * k_t
        num = torch.einsum("bhvk,bhk->bhv", C, q_t) * scale
        den = torch.abs(torch.einsum("bhk,bhk->bh", n, q_t)) * scale
        y[:, t] = (num / torch.maximum(den, torch.exp(-m_new))[..., None]).to(y.dtype)
        m = m_new
    return y, (C, n, m)


def mlstm_chunked(q, k, v, i_gate, f_gate, state=None, chunk_size: int = 64):
    """Chunkwise-parallel mLSTM; matches :func:`mlstm_ref`.

    Memory: O(b · chunk² · h) score blocks + one [b,h,dv,dk] carry.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dk)
    cs = min(chunk_size, s)
    orig_s = s
    if s % cs:
        pad = cs - s % cs
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        # padded steps: f̃ = +40 (forget -> keep state), ĩ = -1e30 (no input)
        i_gate = F.pad(i_gate, (0, 0, 0, pad), value=-1e30)
        f_gate = F.pad(f_gate, (0, 0, 0, pad), value=40.0)
        s = q.shape[1]
    C, n, m = state if state is not None else _mlstm_state0(b, h, dv, dk, q.device)
    tri = torch.ones((cs, cs), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    y = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    for c0 in range(0, s, cs):
        sl = slice(c0, c0 + cs)
        q_c, k_c, v_c = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        i_c = i_gate[:, sl].float()
        logf = F.logsigmoid(f_gate[:, sl].float())          # [b,cs,h]
        bsum = torch.cumsum(logf, dim=1)                     # b_t
        btot = bsum[:, -1]                                   # [b,h]
        # log-weights of each j's (k v) into the end-of-chunk state
        g = i_c + btot[:, None] - bsum                       # [b,cs,h]
        m_state = torch.maximum(btot + m, g.amax(dim=1))     # [b,h]
        # intra-chunk pairwise log decay:  D_tj = b_t − b_j + i_j  (j ≤ t)
        dmat = bsum[:, :, None] - bsum[:, None, :] + i_c[:, None, :]   # [b,t,j,h]
        dmat = dmat.masked_fill(~tri, float("-inf"))
        inter = bsum + m[:, None]                            # [b,t,h]
        m_row = torch.maximum(dmat.amax(dim=2), inter)       # [b,t,h]
        e = torch.exp(dmat - m_row[:, :, None])
        sc = torch.einsum("bthd,bjhd->btjh", q_c, k_c) * scale
        y_intra = torch.einsum("btjh,bjhv->bthv", sc * e, v_c)
        l_intra = torch.einsum("btjh,bjhd->bthd", e, k_c)
        dec = torch.exp(inter - m_row)                       # [b,t,h]
        y_inter = torch.einsum("bthd,bhvd->bthv", q_c, C) * scale * dec[..., None]
        l_inter = n[:, None] * dec[..., None]
        num = y_intra + y_inter           # both carry exactly one `scale`
        lvec = l_intra + l_inter          # raw normalizer vector [b,t,h,dk]
        den = torch.abs(torch.einsum("bthd,bthd->bth", lvec, q_c)) * scale
        y[:, sl] = (num / torch.maximum(den, torch.exp(-m_row))[..., None]).to(y.dtype)
        # state update to the end of the chunk
        wstate = torch.exp(g - m_state[:, None])             # [b,cs,h]
        decay = torch.exp(btot + m - m_state)                # [b,h]
        C = (decay[:, :, None, None] * C
             + torch.einsum("bjhv,bjhd->bhvd", wstate[..., None] * v_c, k_c))
        n = decay[..., None] * n + torch.einsum("bjh,bjhd->bhd", wstate, k_c)
        m = m_state
    return y[:, :orig_s], (C, n, m)


def mlstm_decode(q, k, v, i_gate, f_gate, state):
    """One-token mLSTM step.  q,k,v: [b,1,h,d*]; gates: [b,1,h]."""
    return mlstm_ref(q, k, v, i_gate, f_gate, state)


# ---------------------------------------------------------------- sLSTM core


def slstm_scan(x_z, x_i, x_f, x_o, r_z, r_i, r_f, r_o, state=None):
    """sLSTM over a sequence.  x_*: [b,s,h,d]; r_*: [h,d,d] block-diagonal
    recurrent weights.  Returns (h_seq [b,s,h,d], state).

    state = (c, n, m, h) each [b,h,d] fp32.  The four recurrent products
    of a step run as one batched matmul over the heads.
    """
    b, s, h, d = x_z.shape
    dev = x_z.device
    if state is None:
        c = torch.zeros((b, h, d), dtype=torch.float32, device=dev)
        n = torch.zeros_like(c)
        m = torch.full((b, h, d), LOG_EPS, dtype=torch.float32, device=dev)
        hid = torch.zeros_like(c)
    else:
        c, n, m, hid = state
    r = torch.cat([r_z, r_i, r_f, r_o], dim=-1).float()    # [h, d, 4d]
    xg = torch.stack([x_z, x_i, x_f, x_o], dim=3).float()   # [b, s, h, 4, d]
    y = torch.empty((b, s, h, d), dtype=x_z.dtype, device=dev)
    for t in range(s):
        rec = torch.bmm(hid.transpose(0, 1), r).transpose(0, 1)   # [b, h, 4d]
        pre = xg[:, t] + rec.view(b, h, 4, d)
        z = torch.tanh(pre[:, :, 0])
        itil = pre[:, :, 1]
        logf = F.logsigmoid(pre[:, :, 2])
        o = torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(logf + m, itil)
        fs = torch.exp(logf + m - m_new)
        istab = torch.exp(itil - m_new)
        c = fs * c + istab * z
        n = fs * n + istab
        hid = o * (c / torch.clamp(n, min=1e-6))
        m = m_new
        y[:, t] = hid.to(y.dtype)
    return y, (c, n, m, hid)


# ------------------------------------------------------------- block params


def mlstm_block_specs(d_model: int, num_heads: int, proj_factor: float = 2.0,
                      qk_factor: float = 0.5, d_conv: int = 4) -> dict:
    d_inner = int(proj_factor * d_model)
    dk = int(qk_factor * d_inner)

    def bf_init(gen, shape, dtype):
        del gen
        return (3.0 + torch.arange(shape[0], dtype=torch.float32)).to(dtype)

    return {
        "norm": ParamSpec((d_model,), ("embed",), ones_init),
        "up_proj": ParamSpec((d_model, 2 * d_inner), ("embed", "ssm_inner"), fan_in_init),
        "conv_w": ParamSpec((d_conv, d_inner), ("conv", "ssm_inner"),
                            lambda g, s, d: normal_init(g, s, d, 0.1)),
        "conv_b": ParamSpec((d_inner,), ("ssm_inner",), zeros_init),
        "wq": ParamSpec((d_inner, dk), ("ssm_inner", "heads_qk"), fan_in_init),
        "wk": ParamSpec((d_inner, dk), ("ssm_inner", "heads_qk"), fan_in_init),
        "wv": ParamSpec((d_inner, d_inner), ("ssm_inner", "heads_v"), fan_in_init),
        "wi": ParamSpec((d_inner, num_heads), ("ssm_inner", None),
                        lambda g, s, d: normal_init(g, s, d, 0.02)),
        "wf": ParamSpec((d_inner, num_heads), ("ssm_inner", None),
                        lambda g, s, d: normal_init(g, s, d, 0.02)),
        "bf": ParamSpec((num_heads,), (None,), bf_init),
        "bi": ParamSpec((num_heads,), (None,), zeros_init),
        "out_norm": ParamSpec((d_inner,), ("ssm_inner",), ones_init),
        "down_proj": ParamSpec((d_inner, d_model), ("ssm_inner", "embed"), fan_in_init),
    }


def _row_parallel(shard: Optional[Shard], *products) -> list:
    """Each ``(a, w)`` product's ``a @ w``; over ``shard``'s channels the
    products are partial sums, summed in one collective."""
    out = [a @ w for a, w in products]
    if shard is None or not shard.split:
        return out
    widths = [t.shape[-1] for t in out]
    return list(torch.split(all_reduce_sum(torch.cat(out, dim=-1), shard), widths, dim=-1))


def _out_norm(y: torch.Tensor, scale: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """``rms_norm`` over the whole (replicated) ``y``, at this rank's
    channels of ``shard`` (``scale`` its slice): the statistic reads every
    channel, the same elementwise arithmetic follows."""
    if shard is None or not shard.split:
        return rms_norm(y, scale)
    yf = y.float()
    normed = to_local_region(yf * torch.rsqrt((yf * yf).mean(dim=-1, keepdim=True) + 1e-6),
                             shard)
    return (normed[..., shard.slice] * scale.float()).to(y.dtype)


def mlstm_block_forward(p: dict, x: torch.Tensor, num_heads: int,
                        state=None, conv_state=None, chunk_size: int = 64,
                        decode: bool = False, shard: Optional[Shard] = None):
    """Pre-norm residual mLSTM block.  x: [b,s,d_model]; ``shard``: this
    rank's ``ssm_inner`` channels (None: whole), the conv state the rank's
    channels."""
    b, s, _ = x.shape
    h = rms_norm(x, p["norm"])
    u, z = split_in_proj(h, p["up_proj"], shard)           # [b,s,d_inner] each
    u_c, conv_state = causal_conv1d(u, p["conv_w"], p["conv_b"], conv_state)
    u_act = F.silu(u_c)
    q, k, v, ig, fg = _row_parallel(shard, (u_act, p["wq"]), (u_act, p["wk"]), (u, p["wv"]),
                                    (u_act, p["wi"]), (u_act, p["wf"]))
    q, k, v = (t.reshape(b, s, num_heads, -1) for t in (q, k, v))
    ig, fg = ig + p["bi"], fg + p["bf"]                   # [b,s,h]
    if decode:
        y, state = mlstm_decode(q, k, v, ig, fg, state)
    else:
        y, state = mlstm_chunked(q, k, v, ig, fg, state, chunk_size=chunk_size)
    y = _out_norm(y.reshape(b, s, -1), p["out_norm"], shard) * F.silu(z)
    out = y @ p["down_proj"]
    return x + (out if shard is None else all_reduce_sum(out, shard)), (state, conv_state)


def slstm_d_ff(d_model: int, ff_factor: float = 4.0 / 3.0) -> int:
    """The sLSTM block's gated FFN width."""
    return int(ff_factor * d_model)


def slstm_block_specs(d_model: int, num_heads: int, ff_factor: float = 4.0 / 3.0,
                      d_conv: int = 4) -> dict:
    dh = d_model // num_heads
    d_ff = slstm_d_ff(d_model, ff_factor)

    def r_init(gen, shape, dtype):
        return normal_init(gen, shape, dtype, 1.0 / math.sqrt(shape[-1]))

    def b_zifo_init(gen, shape, dtype):
        del gen
        bias = torch.zeros(shape, dtype=torch.float32)
        # forget-gate bias (third quarter) init positive for long memory
        bias[2 * d_model:3 * d_model] = 3.0
        return bias.to(dtype)

    return {
        "norm": ParamSpec((d_model,), ("embed",), ones_init),
        "conv_w": ParamSpec((d_conv, d_model), ("conv", "embed"),
                            lambda g, s, d: normal_init(g, s, d, 0.1)),
        "conv_b": ParamSpec((d_model,), ("embed",), zeros_init),
        "w_zifo": ParamSpec((d_model, 4 * d_model), ("embed", None), fan_in_init),
        "b_zifo": ParamSpec((4 * d_model,), (None,), b_zifo_init),
        "r_z": ParamSpec((num_heads, dh, dh), (None, None, None), r_init),
        "r_i": ParamSpec((num_heads, dh, dh), (None, None, None), r_init),
        "r_f": ParamSpec((num_heads, dh, dh), (None, None, None), r_init),
        "r_o": ParamSpec((num_heads, dh, dh), (None, None, None), r_init),
        "out_norm": ParamSpec((d_model,), ("embed",), ones_init),
        "ff_norm": ParamSpec((d_model,), ("embed",), ones_init),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ffn"), fan_in_init),
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "ffn"), fan_in_init),
        "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed"), fan_in_init),
    }


def slstm_block_forward(p: dict, x: torch.Tensor, num_heads: int,
                        state=None, conv_state=None, ffn: Optional[Shard] = None,
                        conv: Optional[Shard] = None):
    """Pre-norm sLSTM block + gated FFN.  x: [b,s,d_model].  ``ffn``: this
    rank's shard of the FFN's ``d_ff`` (None: whole); ``conv``: the
    channels of ``d_model`` this rank's conv state holds (None: whole),
    gathered for the conv, which runs whole, and handed back sliced."""
    b, s, d = x.shape
    h = rms_norm(x, p["norm"])
    split_conv = conv is not None and conv.split
    if split_conv and conv_state is not None:
        conv_state = all_gather(conv_state, -1, conv)
    h_c, conv_state = causal_conv1d(h, p["conv_w"], p["conv_b"], conv_state)
    if split_conv:
        conv_state = conv_state[..., conv.slice]
    zifo = F.silu(h_c) @ p["w_zifo"] + p["b_zifo"]
    shp = (b, s, num_heads, d // num_heads)
    xz, xi, xf, xo = (a.reshape(shp) for a in zifo.chunk(4, dim=-1))
    y, state = slstm_scan(xz, xi, xf, xo, p["r_z"], p["r_i"], p["r_f"], p["r_o"], state)
    x = x + rms_norm(y.reshape(b, s, d), p["out_norm"])
    # gated FFN sub-block (pf = 4/3): split on ffn, the partial products summed
    f = rms_norm(x, p["ff_norm"])
    if ffn is None or not ffn.split:
        return x + swiglu(f, p["w_gate"], p["w_up"], p["w_down"]), (state, conv_state)
    f = swiglu(to_local_region(f, ffn), p["w_gate"], p["w_up"], p["w_down"])
    return x + all_reduce_sum(f, ffn), (state, conv_state)
