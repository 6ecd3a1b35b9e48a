"""What one rank's program costs, counted op by op as it executes.

:class:`Accounting` is a ``TorchDispatchMode``: every aten and c10d op that
reaches the dispatcher inside it is counted, on whichever device its
tensors live (the dry run executes on ``meta``; the tests run the same
cells on real CPU tensors under it).  It counts:

* ``flops``: matmul-class flops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, SDPA) under ``torch.utils.flop_counter``'s formulas, the
  ones ``FlopCounterMode`` applies.  The port has no scan over layers, so
  every layer counts.  The kernels' meta implementations
  (``kernels/meta.py``) count their own calls in ``kernels.meta_costs``;
  the dry run adds those.
* ``bytes_accessed``: for each op, the bytes of its tensor inputs and
  outputs.  This is the unfused eager count, which is what the card runs.
  Views (an output that aliases an input) and allocations without a fill
  (``empty``) move nothing and count nothing.
* ``collectives``: operand bytes (the input shard, the reference's
  convention) and counts for each kind — ``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute`` — of the c10d
  and functional-collective ops.  A collective over a group of one rank
  moves nothing and is not counted.
* ``peak_bytes``: the high-water mark of live storage bytes on the
  accounted device.  Each storage counts once (views and in-place ops share
  it) from the op that made it, or from :meth:`Accounting.track` for the
  arguments, until its last reference dies (a weak reference on its
  ``untyped_storage()``).

On ``meta`` an op whose tensors' shapes, strides and dtypes (and whose
other arguments) were seen before returns new tensors of the layout it
returned then, without running its meta kernel again: PyTorch's meta
kernels of elementwise ops are written in Python, and the port's loops
(chunked attention, the chunked scans, the sLSTM's time loop) repeat the
same op on the same shapes thousands of times.  A view, an op that mutates
anything but its first argument, or one whose output shape depends on data
always runs its kernel; an in-place op returns its first argument.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")

# op name -> (kind, index of its input argument)
_COLLECTIVES: Dict[str, tuple] = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::allgather_": ("all-gather", 1),
    "c10d::_allgather_base_": ("all-gather", 1),
    "c10d::allgather_coalesced_": ("all-gather", 1),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d::reduce_scatter_": ("reduce-scatter", 1),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d::alltoall_": ("all-to-all", 1),
    "c10d::alltoall_base_": ("all-to-all", 1),
    "c10d::send": ("collective-permute", 0),
}
for _ns in ("_c10d_functional", "_c10d_functional_autograd"):
    _COLLECTIVES.update({
        f"{_ns}::all_reduce": ("all-reduce", 0),
        f"{_ns}::all_reduce_": ("all-reduce", 0),
        f"{_ns}::all_reduce_coalesced": ("all-reduce", 0),
        f"{_ns}::all_reduce_coalesced_": ("all-reduce", 0),
        f"{_ns}::all_gather_into_tensor": ("all-gather", 0),
        f"{_ns}::all_gather_into_tensor_coalesced": ("all-gather", 0),
        f"{_ns}::reduce_scatter_tensor": ("reduce-scatter", 0),
        f"{_ns}::reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
        f"{_ns}::all_to_all_single": ("all-to-all", 0),
    })

_PLAIN = (torch.Tensor, torch.nn.Parameter)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
               "aten::new_empty_strided", "aten::empty_permuted"}
_DATA_DEPENDENT = (torch.Tag.dynamic_output_shape, torch.Tag.data_dependent_output,
                   torch.Tag.inplace_view)


def _tensors(tree, out=None) -> list:
    """The tensors of nested lists, tuples and dicts (an op's arguments and
    outputs, a cell's argument trees)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def nbytes(tree) -> int:
    """Logical bytes (numel x element size) of the tensors in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args) -> int:
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, ProcessGroup):
            return a.size()
    return _resolve_process_group(args[-1]).size() if isinstance(args[-1], str) else 2


def _op_kind(func) -> str:
    """``view``, ``free`` (an allocation without a fill), ``pure`` (no
    argument or output aliased or written), ``inplace`` (writes its first
    argument only, returns it) or ``other``."""
    schema = func._schema
    if schema.name in _NO_TRAFFIC:
        return "free"
    rets = [r.alias_info for r in schema.returns]
    if any(a is not None and not a.is_write for a in rets):
        return "view"
    if any(t in func.tags for t in _DATA_DEPENDENT) or schema.name in (
            "aten::resize_", "aten::set_", "aten::_local_scalar_dense"):
        return "other"
    written = [i for i, a in enumerate(schema.arguments)
               if a.alias_info is not None and a.alias_info.is_write]
    if not written and not any(rets):
        return "pure"
    if written == [0] and len(rets) == 1 and rets[0] is not None:
        return "inplace"
    return "other"


class _Uncached(Exception):
    pass


def _signature(args) -> tuple:
    """What an op's output layout depends on: each meta tensor's shape,
    strides and dtype, each other argument with its type (``2`` and ``2.0``
    promote differently).  Raises ``_Uncached`` on a tensor off ``meta``."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                raise _Uncached
            out.append((x.shape, x.stride(), x.dtype))
        elif isinstance(x, (list, tuple)):
            out.append(_signature(x))
        elif isinstance(x, (bool, int, float)):
            out.append((type(x), x))
        else:
            out.append(x)
    return tuple(out)


def _layout(out, inputs: set):
    """The outputs' layouts (shape, stride, dtype), or raise if one is not a
    fresh tensor of its own: some ops alias an input without saying so in
    their schema (``_unsafe_view``)."""
    if isinstance(out, torch.Tensor):
        if out.storage_offset() != 0 or out.untyped_storage()._cdata in inputs:
            raise _Uncached
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), [_layout(o, inputs) for o in out])
    if out is None:
        return None
    raise _Uncached


def _rebuild(layout):
    if layout is None:
        return None
    if isinstance(layout[1], list):
        return layout[0](_rebuild(x) for x in layout[1])
    return torch.empty_strided(layout[0], layout[1], dtype=layout[2], device=_META)


_META = torch.device("meta")
# (op, signature) -> (output layout, flops, bytes), or None where the op
# returned no fresh tensor: shared by every Accounting in the process (a
# layout is a function of the signature)
_SEEN: Dict[tuple, tuple] = {}


class Accounting(TorchDispatchMode):
    """Counts flops, bytes accessed, collectives and live storage of the ops
    run inside it (see the module note).  ``device`` is the device whose
    storages count towards the peak (``"meta"`` for the dry run)."""

    @classmethod
    def _should_skip_dynamo(cls):
        return False            # no dynamo guard around every op: nothing here compiles

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = torch.device(device).type
        self.flops = 0
        self.bytes_accessed = 0
        self.collective_bytes = {k: 0 for k in COLLECTIVE_KINDS}
        self.collective_counts = {k: 0 for k in COLLECTIVE_KINDS}
        self.current = 0
        self.peak = 0
        self._live: Dict[int, tuple] = {}
        self._ops: Dict[Any, tuple] = {}

    # ------------------------------------------------------------- memory

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now on."""
        for t in ((tree,) if isinstance(tree, torch.Tensor) else _tensors(tree)):
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._live:
                n = st.nbytes()
                self._live[key] = (n, weakref.ref(st, self._freer(key)))
                self.current += n
                if self.current > self.peak:
                    self.peak = self.current

    def _freer(self, key):
        def free(_ref):
            self.current -= self._live.pop(key)[0]
        return free

    @property
    def collectives(self) -> dict:
        """The reference's record: bytes by kind, ``total`` and ``counts``."""
        return {**self.collective_bytes, "total": sum(self.collective_bytes.values()),
                "counts": dict(self.collective_counts)}

    # ------------------------------------------------------------ dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in types:
            if t not in _PLAIN:
                return NotImplemented       # a tensor subclass (DTensor) unwraps first
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = (_op_kind(func), _COLLECTIVES.get(func._schema.name),
                                      flop_registry.get(func.overloadpacket))
        kind, coll, formula = info
        if coll is not None:
            if _group_size(args) > 1:
                self.collective_bytes[coll[0]] += nbytes(args[coll[1]])
                self.collective_counts[coll[0]] += 1
            out = func(*args, **kwargs)
            self.track(out)
            return out
        key = None
        if self.device == "meta" and (kind == "pure" or kind == "inplace"):
            try:
                key = (func, _signature(args),
                       _signature(sorted(kwargs.items())) if kwargs else ())
                hit = _SEEN.get(key, False)
            except (_Uncached, TypeError):      # off meta, or an unhashable argument
                key = hit = None
            if hit is None:                     # seen, and not a fresh output
                key = None
            elif hit is not False:
                self.flops += hit[1]
                self.bytes_accessed += hit[2]
                if kind == "inplace":
                    return args[0]
                out = _rebuild(hit[0])
                self.track(out)
                return out
        out = func(*args, **kwargs)
        flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        moved = (nbytes(args) + nbytes(kwargs) + nbytes(out)
                 if kind != "view" and kind != "free" else 0)
        self.flops += flops
        self.bytes_accessed += moved
        if key is not None:
            try:
                inputs = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
                _SEEN[key] = (None if kind == "inplace" else _layout(out, inputs), flops, moved)
            except _Uncached:
                _SEEN[key] = None
        if kind != "view":
            self.track(out)
        return out
