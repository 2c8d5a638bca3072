"""What one run of a step costs, counted while it runs: the port's
counterpart of the reference's `compat.cost_analysis` and of its parser of
the compiled program's collectives (`repro/launch/dryrun.py:106-181`).

The reference reads these numbers off XLA's compiled program. The port has
no compiler: it runs the step eagerly, and on `meta` tensors (shapes and
dtypes, no data, no card) a run costs no memory. `counting()` collects, for
the run inside its block:

  * **flops**: the aten ops' by `torch.utils.flop_counter`'s formulas (the
    registry `FlopCounterMode` reads: matrix products, convolutions,
    attention), plus each hand-written kernel's own count, which its meta
    route reports (`kernels/*_meta`, by the formula of the kernel's bound);
  * **bytes accessed**: every dispatched op's tensors read and written
    (each input and output once; a gather reads the rows it returns, a
    scatter writes the rows it is given; views, `empty` and `detach` move
    nothing), plus the kernels' own counts: the traffic of the eager
    program as the port runs it, op by op, unfused;
  * **peak live bytes**: each storage from the op that allocates it until
    it is released, rounded up to 512 bytes as the CUDA caching allocator
    rounds, on top of the storages handed in with `counting(inputs)`. While
    any dispatch mode is active autograd's backward formulas scatter into a
    fresh zero buffer out of place (`zeros.index_put`, not `index_put_`), so
    the output of such a scatter takes over its buffer's bytes, as the
    in-place form the program runs without the mode does;
  * **collectives by kind**: counted where the port's collectives are
    (`mesh.reduce_to` and `all_reduce`, the stage-to-stage sends of
    `distributed.pipeline.fill_drain`, the TP gather of
    `distributed.pipeline_tp`), by their logical operands, with the
    reference's wire factors. They are counted in those functions, not on
    `Tensor.to`: on a mesh whose shards share one device `.to` returns the
    tensor itself and would show nothing.

A meta op's output shapes depend only on its inputs' shapes, strides and
dtypes and its other arguments, so an op seen before with the same ones is
not run again: its outputs are made empty with the shapes it gave, and its
counts are those it had (the eager run of a layer stack repeats the same
ops layer after layer, and PyTorch's meta kernels take ~0.1 ms an op).
Views, in-place ops and ops whose output shares an input's storage always
run.

Eager execution has no scan, so every loop's trips are counted as they run:
the reference's undercount of a scan body (its
`test_roofline_correction.py::test_scan_body_counted_once`) has no
counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import _counting
from repro_torch import tree as T

#: bytes on the wire per byte of operand, a device (ring algorithms), as
#: the reference's `_WIRE_FACTOR`
WIRE_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,          # result bytes ~ wire bytes
    "reduce-scatter": 1.0,      # operand bytes ~ wire bytes
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: the CUDA caching allocator's rounding of a block
ALLOC_ROUND = 512

_aten = torch.ops.aten
#: ops that move no data
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
         _aten.new_empty.default, _aten.new_empty_strided.default, _aten.detach.default,
         _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset}
#: gathers: the source is read only where the output came from
_GATHERS = {_aten.index.Tensor, _aten.index_select.default, _aten.gather.default,
            _aten.embedding.default, _aten.take.default}
#: in-place scatters: the destination is written only where the source goes
_SCATTERS = {_aten.index_put_.default, _aten.index_add_.default, _aten.scatter_.src,
             _aten.scatter_add_.default, _aten.scatter_reduce_.two, _aten.index_copy_.default,
             _aten._index_put_impl_.default}
#: ops that make a fresh buffer (of zeros, or to be filled)
_FRESH = {_aten.new_zeros.default, _aten.zeros_like.default, _aten.zeros.default,
          _aten.new_empty.default, _aten.empty_like.default, _aten.new_full.default,
          _aten.full_like.default, _aten.full.default}
#: the out-of-place forms of the scatters into such a buffer. Under any
#: dispatch mode autograd's backward formulas take these in place of the
#: in-place ones (`at::isTensorSubclassLike` holds while a mode is active:
#: the index backward is zeros.index_put, not zeros.index_put_); without
#: the mode the buffer is written in place, so its output takes over the
#: buffer's bytes
_TAKEOVER = {_aten.index_put.default, _aten.index_add.default, _aten.scatter.src,
             _aten.scatter.value, _aten.scatter_add.default, _aten.scatter_reduce.two,
             _aten.index_copy.default, _aten.slice_scatter.default,
             _aten.select_scatter.default, _aten.diagonal_scatter.default,
             _aten.as_strided_scatter.default, _aten.masked_scatter.default}


def _round(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def _tensors(x) -> list:
    out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            out.extend(_tensors(y))
    elif isinstance(x, dict):
        for y in x.values():
            out.extend(_tensors(y))
    return out


def _touched(t: torch.Tensor) -> int:
    """Bytes an op reads of `t`: its elements, at most its storage (an
    expanded view reads its few elements over and over, from cache)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


@dataclasses.dataclass
class Counts:
    """One run's costs (see the module docstring)."""

    aten_flops: float = 0.0
    aten_bytes: float = 0.0
    peak_bytes: int = 0
    kernels: dict = dataclasses.field(default_factory=dict)
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in WIRE_FACTOR})
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in WIRE_FACTOR})

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(k["flops"] for k in self.kernels.values())

    @property
    def bytes_accessed(self) -> float:
        return self.aten_bytes + sum(k["bytes"] for k in self.kernels.values())

    def collectives(self) -> dict:
        """The reference's record: bytes and counts by kind, and the wire
        bytes (each kind's bytes times its factor)."""
        wire = sum(b * WIRE_FACTOR[k] for k, b in self.collective_bytes.items())
        return {"bytes": dict(self.collective_bytes), "counts": dict(self.collective_counts),
                "wire_bytes": wire}

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def add_collective(self, kind: str, nbytes: float) -> None:
        self.collective_bytes[kind] += nbytes
        self.collective_counts[kind] += 1


_SCALARS = {bool, int, float, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format}


def _key_of(a):
    """A hashable stand-in of an op argument (a meta tensor by its shape,
    strides and dtype, a scalar with its type, so 2 and 2.0 differ); None
    where there is none."""
    t = type(a)
    if t in _SCALARS:
        return (t, a)
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype)
    if t is tuple or t is list:
        parts = tuple(map(_key_of, a))
        return None if None in parts else (t, parts)
    if t is torch.Generator:
        return t
    return None


def _spec_of(out):
    """How to make `out` again: meta tensors only (None otherwise)."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (list, tuple)):
        parts = tuple(_spec_of(o) for o in out)
        return None if None in parts else (type(out), parts)
    return None


def _rebuild(spec):
    if spec[0] == "T":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device="meta")
    return spec[0]([_rebuild(s) for s in spec[1]])


class _Traffic(TorchDispatchMode):
    """Flops and bytes of every dispatched op, and the live storages' peak."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.counts = counts
        self.live: dict[int, int] = {}
        self.current = 0
        self.lock = threading.RLock()
        self.seen: dict = {}
        self.fresh: set = set()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        with self.lock:
            if key in self.live:
                return
            n = _round(st.nbytes()) if st.nbytes() else 0
            self.live[key] = n
            self.current += n
            self.counts.peak_bytes = max(self.counts.peak_bytes, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self.lock:
            self.current -= self.live.pop(key, 0)
            self.fresh.discard(key)

    def _take_over(self, buf: torch.Tensor) -> None:
        """`buf`'s bytes end now: the op's output replaces it, as the
        in-place form writes into it."""
        key = id(buf.untyped_storage())
        with self.lock:
            self.fresh.discard(key)
            if key in self.live:
                self.current -= self.live[key]
                self.live[key] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if (not func.is_view and not func._schema.is_mutable and func not in _FREE
                and all(t.device.type == "meta" for t in _tensors(args))):
            key = _key_of((func.name(), args, tuple(sorted(kwargs.items()))))
        hit = self.seen.get(key) if key is not None else None
        if hit is not None:
            spec, moved, flops = hit
            out = _rebuild(spec)
        else:
            out = func(*args, **kwargs)
            moved, flops = self._cost(func, args, kwargs, out)
            if key is not None:
                spec = _spec_of(out)
                ins = {id(t.untyped_storage()) for t in _tensors(args) + _tensors(kwargs)}
                if spec is not None and not any(id(t.untyped_storage()) in ins
                                                for t in _tensors(out)):
                    self.seen[key] = (spec, moved, flops)
        if (func in _TAKEOVER and isinstance(args[0], torch.Tensor)
                and id(args[0].untyped_storage()) in self.fresh):
            self._take_over(args[0])
        for t in _tensors(out):
            self.track(t)
        if func in _FRESH and isinstance(out, torch.Tensor):
            self.fresh.add(id(out.untyped_storage()))
        self.counts.aten_bytes += moved
        self.counts.aten_flops += flops
        return out

    @staticmethod
    def _cost(func, args, kwargs, out) -> tuple[float, float]:
        packet = func._overloadpacket
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0.0
        if func in _FREE or func.is_view:
            return 0.0, flops
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        if func in _GATHERS:
            moved = sum(_touched(t) for t in ins[1:]) + 2 * sum(_touched(t) for t in outs)
        elif func in _SCATTERS or func in _TAKEOVER:
            moved = 2 * sum(_touched(t) for t in ins[1:])
        else:
            seen = {id(t) for t in ins}
            moved = (sum(_touched(t) for t in ins)
                     + sum(_touched(t) for t in outs
                           if id(t) not in seen or func._schema.is_mutable))
        return float(moved), flops


@contextlib.contextmanager
def counting(*inputs):
    """Count the run inside the block (see the module docstring); the
    storages of `inputs` (trees of tensors) count as live from the start.
    Yields the `Counts`, complete when the block ends."""
    counts = Counts()
    traffic = _Traffic(counts)
    for t in _tensors_of(inputs):
        traffic.track(t)
    _counting.push(counts)
    try:
        with traffic:
            yield counts
    finally:
        _counting.pop(counts)


def _tensors_of(trees) -> list:
    out = []
    for tree in trees:
        out.extend(t for t in T.leaves(tree) if isinstance(t, torch.Tensor))
    return out


def kernel_table(counts: Counts) -> dict:
    return {k: dict(v) for k, v in sorted(counts.kernels.items())}
