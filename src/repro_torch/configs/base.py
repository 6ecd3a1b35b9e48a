"""Model/architecture configuration schema + the layer plan.

A copy of ``repro/configs/base.py``: the port keeps its own so that it
imports nothing of the JAX package.  A config fully determines parameter
shapes, the per-layer block kinds (the *layer plan*: homogeneous segments;
the port runs each as a Python loop over its stacked layers), cache
geometry, and sharding-relevant padding (Q heads to the mesh multiple,
vocab to 256) — see DESIGN.md §7 for the exact-equivalence argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention options ----------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None   # M-RoPE (qwen2-vl)
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()   # full-attn layers in a SWA model
    attn_chunk: int = 512
    causal_skip: bool = False             # triangular chunk schedule (perf)
    # §Perf levers (EXPERIMENTS.md): decode-time KV expansion vs grouped GQA,
    # and shard_map-local MoE dispatch vs GSPMD auto-lowering
    decode_kv_expand: bool = False        # True = baseline (expand KV to H)
    moe_shard_local: bool = True          # False = baseline (GSPMD dispatch)
    parallelism: str = "tp"               # "tp" (model axis on heads/ffn/vocab)
                                          # | "dp" (batch over data AND model —
                                          #   §Perf H3: small models waste the
                                          #   model axis on TP collectives)

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_sharding: str = "ep"              # "ep" | "tp"
    capacity_factor: float = 1.25

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    d_conv: int = 4
    mamba_expand: int = 2
    dt_rank: int = 0                      # 0 -> d_model // 16
    ssm_chunk: int = 128

    # --- xLSTM ---------------------------------------------------------------
    slstm_every: int = 0                  # every Nth block is sLSTM (0 = none)
    mlstm_proj_factor: float = 2.0
    mlstm_qk_factor: float = 0.5
    mlstm_chunk: int = 64

    # --- encoder-decoder ------------------------------------------------------
    enc_layers: int = 0                   # > 0 => encoder-decoder

    # --- inputs ---------------------------------------------------------------
    input_mode: str = "tokens"            # "tokens" | "embeds" (audio/vlm stub)
    num_meta_tokens: int = 0              # hymba learnable prefix

    # --- numerics / misc -------------------------------------------------------
    norm_eps: float = 1e-5
    act: str = "silu"                     # "silu" (SwiGLU) | "gelu"
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"                   # "full" | "none"

    # --- padding for shardability (function-preserving; DESIGN.md §7) ----------
    head_pad_multiple: int = 16           # production model-axis size
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------ derived

    @property
    def padded_heads(self) -> int:
        return _round_up(self.num_heads, self.head_pad_multiple)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §5)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ plan

    def layer_plan(self) -> list["Segment"]:
        """Decoder layer stack as homogeneous segments (one scan each)."""
        if self.family == "ssm":  # xLSTM: mLSTM with periodic sLSTM
            segs: list[Segment] = []
            start = 0
            if self.slstm_every <= 0:
                return [Segment("mlstm", self.num_layers, 0)]
            i = 0
            while i < self.num_layers:
                if (i + 1) % self.slstm_every == 0:
                    segs.append(Segment("slstm", 1, i))
                    i += 1
                else:
                    n = 0
                    j = i
                    while j < self.num_layers and (j + 1) % self.slstm_every != 0:
                        n += 1
                        j += 1
                    segs.append(Segment("mlstm", n, i))
                    i = j
            del start
            return segs

        kind = {"dense": "dense", "vlm": "dense", "moe": "moe",
                "hybrid": "hymba"}.get(self.family)
        if kind is None:
            raise ValueError(f"no decoder plan for family {self.family!r}")
        if not self.global_layers:
            return [Segment(kind, self.num_layers, 0, window=self.sliding_window)]
        # split around full-attention layers (hymba)
        segs = []
        i = 0
        globals_ = set(self.global_layers)
        while i < self.num_layers:
            if i in globals_:
                segs.append(Segment(kind, 1, i, window=None))
                i += 1
            else:
                n = 0
                j = i
                while j < self.num_layers and j not in globals_:
                    n += 1
                    j += 1
                segs.append(Segment(kind, n, i, window=self.sliding_window))
                i = j
        return segs

    def encoder_plan(self) -> list["Segment"]:
        assert self.is_encdec
        return [Segment("encoder", self.enc_layers, 0)]

    def decoder_plan(self) -> list["Segment"]:
        if self.is_encdec:
            return [Segment("xdecoder", self.num_layers, 0)]
        return self.layer_plan()


@dataclasses.dataclass(frozen=True)
class Segment:
    """A run of identical layers lowered as a single scan."""

    kind: str            # dense | moe | hymba | mlstm | slstm | encoder | xdecoder
    count: int
    first_layer: int
    window: Optional[int] = None   # sliding window for attention in this segment

    @property
    def has_attention(self) -> bool:
        return self.kind in ("dense", "moe", "hymba", "encoder", "xdecoder")

    @property
    def has_mamba(self) -> bool:
        return self.kind == "hymba"


# --------------------------------------------------------------------- shapes


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
