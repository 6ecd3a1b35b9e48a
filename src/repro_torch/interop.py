"""Tree and array interop between the JAX package's numpy trees and torch.

Two rules the parity tests and later slices depend on:

* **Flatten order.** :func:`tree_flatten` sorts dict keys, as
  ``jax.tree_util`` does; ``torch.utils._pytree`` keeps insertion order
  instead (``{'b': 1, 'a': 2}`` flattens to ``[2, 1]`` under JAX and
  ``[1, 2]`` under torch).  Packed images and parameter init both walk
  trees in this order.  ``None`` is an empty subtree, as in JAX.  A
  ``NamedTuple`` is a node of its own: its fields flatten in field order
  (JAX's order) and it comes back as the same type, so an optimizer state
  keeps its field names through a tree map or a checkpoint restore.
* **bf16.** ``torch.from_numpy`` rejects ``ml_dtypes.bfloat16`` arrays, so
  bf16 crosses as its bit pattern: ``.view(np.uint16)`` on the numpy side,
  ``.view(torch.bfloat16)`` on the torch side (and back).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# treedef nodes: ("leaf",) | ("none",) | (kind, keys_or_len_or_type, children)


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], tuple]:
    """Leaves in JAX order (dict keys sorted) and a treedef to rebuild.
    ``is_leaf``, as in ``jax.tree_util``, stops the walk at a node it
    accepts (a tree of sharding specs has tuples for leaves)."""
    leaves: List[Any] = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return ("leaf",)
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, tuple) and hasattr(type(node), "_fields"):
            return ("namedtuple", type(node), tuple(walk(c) for c in node))
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return (kind, len(node), tuple(walk(c) for c in node))
        leaves.append(node)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: tuple, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in td[2]]
        if kind == "dict":
            return dict(zip(td[1], children))
        if kind == "namedtuple":
            return td[1](*children)
        return children if kind == "list" else tuple(children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and, leaf by leaf, of each tree
    in ``rest``, which must have the same structure); ``is_leaf`` as in
    :func:`tree_flatten`, applied to ``tree`` and every tree of ``rest``."""
    leaves, td = tree_flatten(tree, is_leaf)
    others = []
    for other in rest:
        o_leaves, o_td = tree_flatten(other, is_leaf)
        if o_td != td:
            raise ValueError("tree_map: trees of different structure")
        others.append(o_leaves)
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy array (bf16 included) -> torch tensor on ``device``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy.  bf16 comes back as its ``np.uint16`` bit
    pattern (view it as ``ml_dtypes.bfloat16`` where that is installed)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree: Any, device="cuda", cfg=None) -> Any:
    """The JAX package's ``init_params`` tree, as numpy arrays, -> the
    port's parameter tree: identical keys, shapes and dtypes.

    With ``cfg``, checks the invariant the port's decode relies on: the
    ``wo`` rows of padded query heads are zero, in every attention and
    cross-attention of the encoder and the decoder (the attention kernels
    write zeros for those heads instead of computing them).
    """
    from . import resolve_device

    dev = resolve_device(device)
    params = tree_map(lambda a: from_numpy(np.asarray(a), dev), tree)
    if cfg is not None and cfg.padded_heads != cfg.num_heads:
        rows = cfg.num_heads * cfg.head_dim
        wos = [seg[a]["wo"] for seg in params["segments"] + params.get("encoder", [])
               for a in ("attn", "xattn") if a in seg]   # [L, Hp*D, E] each
        for wo in wos:
            if torch.count_nonzero(wo[:, rows:]).item():
                raise ValueError(
                    "padded-head rows of wo are not zero; the port's decode "
                    "drops padded heads and would change the function")
    return params
