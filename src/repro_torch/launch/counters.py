"""What one step does on this rank, counted as it runs: the port's
counterpart of ``repro/launch/hlo.py`` and of ``dryrun.collective_bytes``.

The reference reads a compiled program's text: the result shapes of its
collectives, ``cost_analysis()``'s FLOPs and bytes accessed, and
``memory_analysis()``'s buffers.  The port runs eagerly and has no such
text, so :class:`Recorder` (a ``TorchDispatchMode``) watches every op the
step dispatches, on real tensors or on the fake ones of the dry run
(``launch/dryrun.py``), and keeps four things:

* **collectives**: calls and bytes per kind under the reference's keys
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``); another kind (``broadcast``) under its own
  name.  Bytes are the result's, the reference's convention: the output
  buffers of a ``c10d`` op (the process group's, as ``dist.all_reduce``
  issues them), the returned tensors of a ``_c10d_functional`` op (as
  ``DTensor`` issues them).  A send/recv pair is one
  ``collective-permute``: the recv's buffer.  Eager execution runs every
  layer, microbatch and recompute as itself, so the count is already the
  one ``hlo.py``'s while-trip correction computes;
* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s total (and
  by op);
* **bytes accessed**: the bytes of every input and output tensor of every
  ``aten`` op and every op of the port's own (``repro::linear_scan``)
  that is not a view, XLA's ``"bytes accessed"`` convention (and by op);
* **memory**: the storage the step allocated (each storage counted once,
  from the op that made it to its death), its live total and peak; the
  storages of the arguments (:meth:`Recorder.__init__`) are not counted.

:func:`collective_bytes` gives the reference's ``{op: bytes, "total"}``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import register_flop_formula

from ..kernels.linear_scan.ops import NAMESPACE

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d and _c10d_functional op names -> the reference's key
_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}
# ops of those namespaces that move nothing of their own
_NOT_COUNTED = {"wait_tensor", "send"}
# the namespaces whose ops count toward bytes accessed and memory: ATen's
# and the port's own ops
COUNTED = ("aten", NAMESPACE)


@register_flop_formula(getattr(torch.ops, NAMESPACE).linear_scan)
def _linear_scan_flop(a_shape, *args, **kwargs) -> int:
    """A multiply and an add an element and step.  XLA counts the
    reference's associative scan higher, about 2 log2(T) an element: its
    odd/even recursion combines each pair once a level."""
    return 2 * a_shape[0] * a_shape[1] * a_shape[2]


def kind_of(func) -> str | None:
    """The key a collective op's record goes under; None for another op."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    if name in _NOT_COUNTED:
        return None
    return _KIND.get(name, name.strip("_").replace("_", "-"))


def _tensors(tree) -> list:
    """The plain tensors of ``tree`` (a ``DTensor``'s local one): a
    module's parameters and buffers, a dataclass's fields and the leaves
    of containers."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(getattr(x, "_local_tensor", x))
        elif isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                walk(t)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree, exclude: Iterable[int] = ()) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors (a
    ``DTensor``'s local one), leaving out the storages in ``exclude``
    (:func:`storage_keys`)."""
    seen, total = set(exclude), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def storage_keys(tree) -> set:
    """The storages of ``tree``'s tensors, as :func:`storage_bytes` names
    them."""
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


class Recorder(TorchDispatchMode):
    """Counts what the ops run under it do (module docstring).  Enter it
    inside a ``FakeTensorMode`` to count a step on fake tensors.
    ``arguments``: the step's arguments, whose storages are not counted
    as the step's memory."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.bytes_accessed = 0
        self._bytes_by_op: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._args = storage_keys(arguments)
        self._held: Dict[int, int] = {}
        self._flops = FlopCounterMode(display=False)

    def __enter__(self):
        self._flops.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._flops.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._flops.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def flops_by_op(self) -> Dict[str, int]:
        """The FLOPs of each counted op (``aten.mm`` ...), largest first."""
        got = self._flops.get_flop_counts().get("Global", {})
        return dict(sorted(((str(k), int(v)) for k, v in got.items()),
                           key=lambda kv: -kv[1]))

    def bytes_by_op(self) -> Dict[str, int]:
        """The bytes accessed of each counted op, largest first."""
        return dict(sorted(self._bytes_by_op.items(), key=lambda kv: -kv[1]))

    def _free(self, key: int, nbytes: int) -> None:
        if self._held.pop(key, None) is not None:
            self.live -= nbytes

    def _hold(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._args:
                continue
            n = st.nbytes()
            self._held[key] = n
            weakref.finalize(st, self._free, key, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = kind_of(func)
        if kind is not None:
            buf = args[0] if func.namespace == "c10d" else out
            rec = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += sum(_nbytes(t) for t in _tensors(buf))
            return out
        if func.namespace not in COUNTED:
            return out
        outs = _tensors(out)
        self._hold(outs)
        if not func.is_view:
            n = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            self.bytes_accessed += n
            op = str(func.overloadpacket)
            self._bytes_by_op[op] = self._bytes_by_op.get(op, 0) + n
        return out

    def calls(self) -> Dict[str, int]:
        return {k: v["calls"] for k, v in sorted(self.collectives.items())}


def collective_bytes(records) -> Dict[str, int]:
    """``{op: bytes, ..., "total": ...}`` of a :class:`Recorder`'s
    ``collectives`` (or the recorder itself), the reference's keys."""
    if isinstance(records, Recorder):
        records = records.collectives
    out = {k: v["bytes"] for k, v in sorted(records.items())}
    out["total"] = sum(out.values())
    return out
