"""Shared model utilities: initializers and parameter-spec trees.

Port of ``repro/models/common.py``.  Initializers draw from an explicit
``torch.Generator`` (on the CPU, so a seed gives the same weights on every
device) instead of split ``jax.random`` keys; the two give different
numbers from one seed, so the parity tests convert the JAX package's
weights with :func:`repro_torch.interop.params_from_numpy` instead.  Trees
are walked in JAX order (dict keys sorted), so each leaf draws from the
generator at the same position in both layouts.  The spec-tree views
(``logical_axes_tree``, ``shapes_tree``) keep JAX's tree too: their
leaves are tuples, so walk them with ``is_leaf=is_tuple``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from ..interop import tree_flatten, tree_map, tree_unflatten

PyTree = Any


# ----------------------------------------------------------------- initializers


def normal_init(gen, shape, dtype, stddev):
    return (stddev * torch.randn(shape, generator=gen, dtype=torch.float32)).to(dtype)


def fan_in_init(gen, shape, dtype, fan_in: Optional[int] = None):
    """Normal init scaled by 1/sqrt(fan_in)."""
    fi = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(gen, shape, dtype, 1.0 / math.sqrt(max(1, fi)))


def zeros_init(gen, shape, dtype):
    del gen
    return torch.zeros(shape, dtype=dtype)


def ones_init(gen, shape, dtype):
    del gen
    return torch.ones(shape, dtype=dtype)


# ----------------------------------------------------------------- param spec


@dataclasses.dataclass
class ParamSpec:
    """Shape + logical axes + initializer for one parameter tensor."""

    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    init: Callable = fan_in_init

    def make(self, gen, dtype):
        return self.init(gen, self.shape, dtype)


def init_param_tree(spec_tree: PyTree, gen: torch.Generator, dtype,
                    device) -> PyTree:
    """Initialize a tree of ParamSpec from one generator, leaves in JAX
    order, then move every tensor to ``device``."""
    leaves, treedef = tree_flatten(spec_tree)
    vals = [spec.make(gen, dtype).to(device) for spec in leaves]
    return tree_unflatten(treedef, vals)


def stack_specs(spec_tree: PyTree, n: int) -> PyTree:
    """Prepend a stacking dim of size n (the per-segment layer stack)."""

    def _stack(s: ParamSpec) -> ParamSpec:
        return ParamSpec(shape=(n,) + s.shape,
                         logical_axes=(None,) + s.logical_axes,
                         init=_stacked_init(s.init, n))

    return tree_map(_stack, spec_tree)


def _stacked_init(init: Callable, n: int) -> Callable:
    def f(gen, shape, dtype):
        return torch.stack([init(gen, shape[1:], dtype) for _ in range(n)])

    return f


def is_tuple(v) -> bool:
    """A leaf of a spec-tree view: a plain tuple (logical axes, a shape or a
    partition spec); the parameter trees hold no plain tuple as a node."""
    return type(v) is tuple


def logical_axes_tree(spec_tree: PyTree) -> PyTree:
    return tree_map(lambda s: tuple(s.logical_axes), spec_tree)


def shapes_tree(spec_tree: PyTree) -> PyTree:
    return tree_map(lambda s: tuple(s.shape), spec_tree)


def count_params(params: PyTree) -> int:
    return sum(math.prod(p.shape) for p in tree_flatten(params)[0])


def tree_bytes(params: PyTree) -> int:
    return sum(p.numel() * p.element_size() for p in tree_flatten(params)[0])
