"""Random weights from ``--seed``, made on the device in the served dtype.

Every leaf is drawn layer by layer from a generator of its own, seeded
from (seed, leaf, layer), so the reference can draw any one layer again,
bit for bit, without the others and without anything the program holds.
The engine gets the stacked tensors in the parameter tree the port's
``ServeEngine`` takes (one segment, layers stacked); ``run.py`` holds the
tree's shapes to the port's own ``param_specs`` before the engine sees it.

Scales: the embedding N(0, 1) (every layer reads it through an RMS norm),
each product N(0, 1/fan_in), norms one; so the logits have a spread of
about one at any width.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str                       # the reference's name
    path: Tuple[str, ...]           # where the engine's tree holds it
    shape: Tuple[int, ...]          # one layer's shape (or the whole leaf's)
    std: Optional[float]            # None: ones (a norm's scale)
    per_layer: bool = True


def leaves(cfg: dict) -> List[Leaf]:
    """The leaves of one configuration (published key names in ``cfg``)."""
    d, h, kv = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, f, v = d // h, cfg["intermediate_size"], cfg["vocab_size"]
    out = [
        Leaf("embed", ("embed",), (v, d), 1.0, per_layer=False),
        Leaf("lm_head", ("lm_head",), (d, v), d ** -0.5, per_layer=False),
        Leaf("final_norm", ("final_norm",), (d,), None, per_layer=False),
        Leaf("ln1", ("ln1",), (d,), None),
        Leaf("wq", ("attn", "wq"), (d, h * hd), d ** -0.5),
        Leaf("wk", ("attn", "wk"), (d, kv * hd), d ** -0.5),
        Leaf("wv", ("attn", "wv"), (d, kv * hd), d ** -0.5),
        Leaf("wo", ("attn", "wo"), (h * hd, d), (h * hd) ** -0.5),
        Leaf("ln2", ("ln2",), (d,), None),
    ]
    e = cfg.get("num_local_experts") or 0
    if e:
        out += [Leaf("router", ("moe", "router"), (d, e), d ** -0.5),
                Leaf("w_gate", ("moe", "w_gate"), (e, d, f), d ** -0.5),
                Leaf("w_up", ("moe", "w_up"), (e, d, f), d ** -0.5),
                Leaf("w_down", ("moe", "w_down"), (e, f, d), f ** -0.5)]
    else:
        out += [Leaf("w_gate", ("mlp", "w_gate"), (d, f), d ** -0.5),
                Leaf("w_up", ("mlp", "w_up"), (d, f), d ** -0.5),
                Leaf("w_down", ("mlp", "w_down"), (f, d), f ** -0.5)]
    return out


def _generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") & ((1 << 63) - 1))


def _fill(t: torch.Tensor, leaf: Leaf, seed: int, layer: int) -> torch.Tensor:
    if leaf.std is None:
        return t.fill_(1.0)
    return t.normal_(0.0, leaf.std, generator=_generator(seed, leaf.name, layer, t.device))


def engine_params(cfg: dict, seed: int, dtype: torch.dtype, device) -> dict:
    """The whole parameter tree, in ``dtype`` on ``device``: one stacked
    tensor a leaf, filled one layer at a time."""
    layers = cfg["num_hidden_layers"]
    seg: Dict[str, dict] = {}
    tree: Dict[str, object] = {"segments": [seg]}
    for leaf in leaves(cfg):
        if leaf.per_layer:
            t = torch.empty((layers, *leaf.shape), dtype=dtype, device=device)
            for i in range(layers):
                _fill(t[i], leaf, seed, i)
            node = seg
        else:
            t = _fill(torch.empty(leaf.shape, dtype=dtype, device=device), leaf, seed, -1)
            node = tree
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = t
    return tree


class ReferenceWeights:
    """The same weights drawn again, one layer at a time, in float32: what
    the reference reads.  Nothing here touches the engine's tensors."""

    def __init__(self, cfg: dict, seed: int, dtype: torch.dtype, device):
        self.cfg, self.seed, self.dtype, self.device = cfg, seed, dtype, device
        self.leaves = leaves(cfg)

    def _draw(self, leaf: Leaf, layer: int) -> torch.Tensor:
        t = torch.empty(leaf.shape, dtype=self.dtype, device=self.device)
        return _fill(t, leaf, self.seed, layer).float()

    def top(self, name: str) -> torch.Tensor:
        leaf = next(x for x in self.leaves if x.name == name and not x.per_layer)
        return self._draw(leaf, -1)

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        return {x.name: self._draw(x, i) for x in self.leaves if x.per_layer}
