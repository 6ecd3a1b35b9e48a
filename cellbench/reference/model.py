"""A plain float32 forward pass of the served decoder models, from the
published description of each (``configs/<name>.json`` key names).

* ``llama`` (DeepSeek LLM 7B): pre-norm blocks, RMSNorm, rotary embedding
  in the half-rotation layout (``rotate_half``), multi-head (or grouped)
  causal attention, a SwiGLU MLP, an untied LM head.
* ``mixtral``: the same attention, and a sparse MoE FFN: softmax over the
  router's logits, the top ``num_experts_per_tok`` experts, their weights
  renormalised to sum one, every routed token through its experts (no
  capacity, nothing dropped).

A route is a discrete choice: where the last chosen expert's router logit
lies within rounding of the first one left out, a bfloat16 server may
pick either, and a flipped route moves that position's logits by O(1).
``margins`` holds, for each sequence's positions, the smallest such lead
over the layers.  With ``flip_margin`` the reference also follows, for
every served position, each route within ``flip_margin`` of a tie taken
the other way, at up to ``FLIP_DEPTH`` layers of that position's path
(``alternatives``: those positions' logits under each such routing; the
other positions' keys and values stay the plain routing's).
``router_dtype`` rounds the router's logits to a served precision first.

Every product runs through ``self.linear`` (plain ``x @ w`` here; the
control in ``quant.py`` lowers its precision) and the attention and norms
in float32.  The forward runs layer by layer over all the sequences it is
given, so one layer's weights are drawn (``weights.layer(i)``) and freed
at a time.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

FLIP_DEPTH = 2              # flipped routes a position's path may take
ROW_BLOCK = 128             # rows of followed routings attended at a time


def no_tf32() -> None:
    """Float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float, pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [S, heads, D] at positions ``pos`` (0..S-1 by default),
    half-rotation layout."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    pos = torch.arange(s, device=x.device) if pos is None else pos
    ang = pos.to(torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Reference:
    def __init__(self, cfg: dict, weights, head_block: int = 8,
                 router_dtype: str = None, flip_margin: float = None):
        self.cfg = cfg
        self.w = weights
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.kv = cfg["num_key_value_heads"]
        self.hd = self.d // self.h
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.window = cfg.get("sliding_window")
        self.top_k = cfg.get("num_experts_per_tok") or 0
        self.head_block = head_block
        self.router_dtype = getattr(torch, router_dtype) if router_dtype else None
        self.flip_margin = flip_margin
        self.margins: List[torch.Tensor] = []
        self.alternatives: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = []
        self._margin = None
        self._kv = None

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def attention(self, x: torch.Tensor, p: dict) -> torch.Tensor:
        s = x.shape[0]
        q = rope(self.linear(x, p["wq"]).view(s, self.h, self.hd), self.theta)
        k = rope(self.linear(x, p["wk"]).view(s, self.kv, self.hd), self.theta)
        v = self.linear(x, p["wv"]).view(s, self.kv, self.hd)
        self._kv = (k, v)
        rep = self.h // self.kv
        pos = torch.arange(s, device=x.device)
        dist = pos[:, None] - pos[None, :]
        visible = dist >= 0
        if self.window:
            visible &= dist < self.window
        out = torch.empty_like(q)
        for h0 in range(0, self.h, self.head_block):
            hs = range(h0, min(h0 + self.head_block, self.h))
            qh = q[:, hs.start:hs.stop].transpose(0, 1)                  # [h, S, D]
            kvi = [h // rep for h in hs]
            kh, vh = k[:, kvi].transpose(0, 1), v[:, kvi].transpose(0, 1)
            sc = (qh @ kh.transpose(1, 2)) / self.hd ** 0.5
            sc = sc.masked_fill(~visible, float("-inf")).softmax(dim=-1)
            out[:, hs.start:hs.stop] = (sc @ vh).transpose(0, 1)
        return self.linear(out.reshape(s, self.h * self.hd), p["wo"])

    def attend_rows(self, x: torch.Tensor, pos: torch.Tensor, kv, p: dict) -> torch.Tensor:
        """Attention of rows ``x`` [n, d] at positions ``pos`` over the
        plain routing's keys and values ``kv`` of the positions before
        each, and their own."""
        n, rep, scale = x.shape[0], self.h // self.kv, self.hd ** -0.5
        q = rope(self.linear(x, p["wq"]).view(n, self.h, self.hd), self.theta, pos)
        k = rope(self.linear(x, p["wk"]).view(n, self.kv, self.hd), self.theta, pos)
        v = self.linear(x, p["wv"]).view(n, self.kv, self.hd)
        kc, vc = (t.repeat_interleave(rep, dim=1) for t in kv)             # [S, h, D]
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        spos = torch.arange(kc.shape[0], device=x.device)
        out = torch.empty_like(q)
        for r0 in range(0, n, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, n)
            dist = pos[r0:r1, None] - spos[None, :]
            visible = dist > 0
            if self.window:
                visible &= dist < self.window
            sc = torch.einsum("nhd,shd->nhs", q[r0:r1], kc) * scale
            sc = sc.masked_fill(~visible[:, None, :], float("-inf"))
            own = (q[r0:r1] * k[r0:r1]).sum(-1, keepdim=True) * scale
            pr = torch.cat([sc, own], dim=-1).softmax(dim=-1)
            out[r0:r1] = torch.einsum("nhs,shd->nhd", pr[..., :-1], vc) + pr[..., -1:] * v[r0:r1]
        return self.linear(out.reshape(n, self.h * self.hd), p["wo"])

    def ffn(self, x: torch.Tensor, p: dict, flip: bool = False) -> torch.Tensor:
        """The FFN; a MoE's ``flip`` takes, for every row, the first expert
        left out in place of the last one chosen."""
        if "router" not in p:
            return self.linear(torch.nn.functional.silu(self.linear(x, p["w_gate"]))
                               * self.linear(x, p["w_up"]), p["w_down"])
        k = self.top_k
        logit = x @ p["router"]
        if self.router_dtype is not None:
            logit = logit.to(self.router_dtype).float()
        probs = logit.softmax(dim=-1)
        top_w, top_i = probs.topk(k + 1, dim=-1)
        near = logit.gather(1, top_i[:, k - 1:])
        self._margin = near[:, 0] - near[:, 1]
        if flip:
            top_w[:, k - 1], top_i[:, k - 1] = top_w[:, k], top_i[:, k]
        top_w, top_i = top_w[:, :k], top_i[:, :k]
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
        y = torch.zeros_like(x)
        for e in range(p["router"].shape[1]):
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            he = torch.nn.functional.silu(self.linear(xe, p["w_gate"][e])) \
                * self.linear(xe, p["w_up"][e])
            y.index_add_(0, rows, self.linear(he, p["w_down"][e]) * top_w[rows, slot, None])
        return y

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor], starts: Sequence[int]) -> List[torch.Tensor]:
        """For each token sequence (int64 on the device), the float32 logits
        of its rows ``[start, len)``: row ``j`` predicts token ``j + 1``."""
        emb = self.w.top("embed")
        xs = [emb[s] for s in seqs]
        del emb
        self.margins = [torch.full((len(s),), float("inf"), device=s.device) for s in seqs]
        alts = [None] * len(seqs)       # followed routings: (positions, flips, hidden)
        for i in range(self.cfg["num_hidden_layers"]):
            p = self.w.layer(i)
            for j, x in enumerate(xs):
                h = x + self.attention(rms_norm(x, p["ln1"], self.eps), p)
                xs[j] = h + self.ffn(rms_norm(h, p["ln2"], self.eps), p)
                if self._margin is not None:
                    self.margins[j] = torch.minimum(self.margins[j], self._margin)
                    if self.flip_margin is not None:
                        alts[j] = self._follow(alts[j], h, starts[j], p)
            del p
        self.margins = [m[st:] for m, st in zip(self.margins, starts)]
        norm, head = self.w.top("final_norm"), self.w.top("lm_head")
        self.alternatives = [None if a is None else
                             (a[0] - st, self.linear(rms_norm(a[2], norm, self.eps), head))
                             for a, st in zip(alts, starts)]
        return [self.linear(rms_norm(x[st:], norm, self.eps), head) for x, st in zip(xs, starts)]

    def _follow(self, alt, h: torch.Tensor, start: int, p: dict):
        """One layer of the followed routings of a sequence: the plain
        routing's served positions whose route here lies within
        ``flip_margin`` of a tie start one, flipped here; each one already
        followed goes through the layer and, near a tie, also branches."""
        margin, kv = self._margin, self._kv
        pos = start + (margin[start:] < self.flip_margin).nonzero()[:, 0]
        n = rms_norm(h[pos], p["ln2"], self.eps)
        parts = [(pos, torch.ones_like(pos), h[pos] + self.ffn(n, p, flip=True))]
        if alt is not None and len(alt[0]):
            apos, flips, ax = alt
            ah = ax + self.attend_rows(rms_norm(ax, p["ln1"], self.eps), apos, kv, p)
            an = rms_norm(ah, p["ln2"], self.eps)
            parts.insert(0, (apos, flips, ah + self.ffn(an, p)))
            more = (self._margin < self.flip_margin) & (flips < FLIP_DEPTH)
            if more.any():
                parts.append((apos[more], flips[more] + 1,
                              ah[more] + self.ffn(an[more], p, flip=True)))
        return tuple(torch.cat(t) for t in zip(*parts))
