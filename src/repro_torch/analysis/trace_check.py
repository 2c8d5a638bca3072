"""Trace backend: the engine steps on the card (rules ACC-J102/J103,
DESIGN.md §16), the counterpart of the reference's IR backend
(`repro.analysis.jaxpr_check`).

The reference traces every catalog program through its jitted entry points
with abstract values and walks the IR. The port's engine is eager PyTorch
driven by a host loop, so there is no IR to walk: this backend runs each
entry's one-iteration step on a CUDA device instead, with telemetry off
(except the entry that names it) and the counted host reads (`HOST_READS`,
`ShardedBatchEngine.flags`) made before the step, as its callers make them.

**ACC-J102 (§12 transfer-free step).** The step runs once under
`torch.cuda.set_sync_debug_mode("error")`: any synchronizing operation
(`.item()`, `.tolist()`, a `bool()` of a device tensor, `nonzero`, boolean
indexing) or host->device copy from pageable memory raises, and becomes a
finding anchored at the innermost frame of the port that made it.

**ACC-J103 (§8 static shapes).** The step is captured in a CUDA graph
(`torch.cuda.graph`, on its side stream after a warm-up step, into a
private memory pool that is dropped after the entry): a failed capture is a
finding (a data-dependent shape, or an allocation or copy that cannot be
replayed). The capture is replayed once and compared bit for bit with an
eager step; a difference is a finding too. A step that fails J102 cannot be
captured either, so it also fails J103; a capture that fails leaves the
next one working (the context is not poisoned).

**ACC-J101 (§9 deadlock-free barrier) has no counterpart.** The port's
mesh is single-controller: `repro_torch.mesh` runs its collectives as host
functions over per-shard tensors, one process drives every shard, and no
device-side barrier exists to deadlock. A device-resident fused loop with
a global barrier (the paper's persistent kernel) would bring the rule back.

This backend needs a CUDA device: it refuses the CPU.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, Optional

import torch

from .findings import Finding

_PACKAGE = str(Path(__file__).resolve().parent.parent)


def require_cuda(device) -> torch.device:
    """The CUDA device the backend runs on; raises for anything else."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"the trace backend runs engine steps on a CUDA device (sync "
            f"debug mode and CUDA-graph capture); got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("the trace backend needs a CUDA device; none is "
                           "available")
    return dev


def _leaves(x) -> list:
    """Every tensor of a state: tensors, dicts, tuples/lists, NamedTuples
    and dataclasses, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [t for f in dataclasses.fields(x) for t in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _same(a: list, b: list) -> Optional[str]:
    """None when two states are equal bit for bit, else what differs."""
    if len(a) != len(b):
        return f"{len(a)} tensors against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype:
            return (f"tensor {i}: {tuple(x.shape)} {x.dtype} against "
                    f"{tuple(y.shape)} {y.dtype}")
        if not torch.equal(_bits(x), _bits(y)):
            return f"tensor {i} ({tuple(x.shape)} {x.dtype}) differs"
    return None


def _where(exc: BaseException) -> str:
    """file:line of the innermost frame of the port (outside this backend)
    in an exception's traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(_PACKAGE)
              and not f.filename.endswith(("trace_check.py", "fixtures.py"))]
    if not frames:
        frames = traceback.extract_tb(exc.__traceback__)[-1:]
    if not frames:
        return "?"
    f = frames[-1]
    name = f.filename[len(_PACKAGE) + 1:] if f.filename.startswith(_PACKAGE) \
        else Path(f.filename).name
    return f"{name}:{f.lineno} `{(f.line or '').strip()}`"


def _sync_check(entry: str, step: Callable, st) -> list[Finding]:
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "a prototype feature"
        torch.cuda.set_sync_debug_mode("error")
    try:
        step(st)
    except RuntimeError as e:
        what = "synchronizing operation" if "synchroniz" in str(e) else \
            f"{type(e).__name__}: {str(e)[:200]}"
        return [Finding("ACC-J102", entry, 0,
                        f"{what} inside the step at {_where(e)} — a step with "
                        "telemetry off must not wait for the device or copy "
                        "from pageable host memory (DESIGN.md §12)")]
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return []


def _capture_check(entry: str, step: Callable, st, eager: list) -> list[Finding]:
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    side = torch.cuda.Stream()
    captured = None
    try:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(st)                     # warm-up on a side stream
        torch.cuda.current_stream().wait_stream(side)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # "the CUDA Graph is empty"
            with torch.cuda.graph(graph, pool=pool):
                captured = _leaves(step(st))
        graph.replay()
        diff = _same(captured, eager)
    except Exception as e:                              # noqa: BLE001
        return [Finding("ACC-J103", entry, 0,
                        f"CUDA-graph capture failed at {_where(e)}: "
                        f"{type(e).__name__}: {str(e).splitlines()[0][:200]} — "
                        "a data-dependent shape, a sync, or an allocation or "
                        "copy that cannot be replayed (DESIGN.md §8)")]
    finally:
        del graph, captured
        torch.cuda.empty_cache()
    if diff is not None:
        return [Finding("ACC-J103", entry, 0,
                        f"the captured step's replay differs from an eager "
                        f"step: {diff} (DESIGN.md §8)")]
    return []


def check_step(entry: str, make: Callable[[], tuple]) -> list[Finding]:
    """Check one entry. `make()` builds (step, state) on the card; the step
    maps a state to the next one and must leave its input unchanged. A
    failure to build or run it eagerly is an ACC-J103 finding, as a trace
    failure is in the reference."""
    try:
        step, st = make()
        eager = _leaves(step(st))        # warm-up: builds kernels, fills caches
    except Exception as e:                              # noqa: BLE001
        return [Finding("ACC-J103", entry, 0,
                        f"the step failed to run at {_where(e)}: "
                        f"{type(e).__name__}: {str(e)[:300]}")]
    return _sync_check(entry, step, st) + _capture_check(entry, step, st, eager)


# ---------------------------------------------------------------------------
# engine entry points
# ---------------------------------------------------------------------------


def _solo(program, g, pack, cfg, kw, direction: str):
    from repro_torch.core import engine as E

    def make():
        st = E.init_state(program, g, cfg, **kw)
        if direction == "push":
            def step(s):
                return E._policy(program, cfg, g.n_edges,
                                 E._push_step(program, g.out, cfg, s))
        else:
            pull_fn = E.make_kernel_pull(program) if cfg.pull_impl == "kernel" else None

            def step(s):
                return E._policy(program, cfg, g.n_edges,
                                 E._pull_step(program, pack, cfg, s, g.out, pull_fn))
        return step, st
    return make


def _batched(program, g, pack, cfg, q: int, gmode: int):
    from repro_torch.serving import batch_engine as B

    def make():
        st = B.init_batch(program, g, cfg, list(range(q)),
                          pack=pack if cfg.masked_pull else None)
        step = B.make_batched_step(program, g, pack, cfg)
        return (lambda s: step(s, gmode)), st
    return make


def _sharded(program, g, pack, cfg, q: int, dev, placement: str, telemetry: bool):
    from repro_torch.serving.sharded import ShardedBatchEngine, make_serving_mesh

    def make():
        shape = (2, 1) if placement == "replicated" else (1, 2)
        mesh = make_serving_mesh(*shape, devices=[dev] * 2)
        eng = ShardedBatchEngine(program, g, pack, cfg, mesh,
                                 placement=placement, telemetry=telemetry)
        rows = eng.init(list(range(q)))
        flags = eng.flags(rows)          # the counted read, before the step
        return (lambda r: eng.step(r, flags)), rows
    return make


def catalog_entries(programs: Optional[dict] = None, scale: int = 6,
                    sharded: bool = True, device="cuda", graph=None):
    """Yield (entry_name, make) for every catalog program x engine step.

    Per program: the solo push and pull steps (`core/engine.py`
    `_push_step`/`_pull_step` with the controller), the batched step
    (`make_batched_step(...)(st, gmode)`) in each direction with the dense
    pull, the masked pull as an entry of its own, and the sharded step
    (`ShardedBatchEngine.step` with its flags read first) replicated and
    edge-sharded, the latter also with telemetry. A program runs only the
    directions its `modes` allow. The graph is a scale-`scale` directed RMAT
    (edge factor 4, seed 1, as the reference traces), or `graph` = (g, pack)
    already on the device, whose entries are tagged with its vertex count.
    """
    from repro_torch.core.engine import PULL, PUSH
    from repro_torch.graph import generators, pack_ell
    from repro_torch.launch.catalog import make_catalog
    from repro_torch.serving import batch_engine as B
    from repro_torch.serving.scheduler import default_config

    dev = require_cuda(device)
    if programs is None:
        programs = make_catalog()
    if graph is None:
        g = generators.rmat(scale, 4, seed=1, directed=True, device=dev)
        pack = pack_ell(g.inc)
        tag = ""
    else:
        g, pack = graph
        tag = f"@n{g.n_nodes}"
    cfg = default_config(g, max_iters=64)
    masked_cfg = dataclasses.replace(cfg, masked_pull=True)
    q = 2

    for name, program in programs.items():
        kw = {"source": 0} if B._accepts_source(program) else {}
        dirs = [d for d in ("push", "pull")
                if program.modes in ("both", d)]
        for d in dirs:
            yield f"trace:{name}/solo_{d}{tag}", _solo(program, g, pack, cfg, kw, d)
        for d in dirs:
            yield (f"trace:{name}/batched_{d}{tag}",
                   _batched(program, g, pack, cfg, q, PUSH if d == "push" else PULL))
        if "pull" in dirs:
            yield (f"trace:{name}/batched_masked_pull{tag}",
                   _batched(program, g, pack, masked_cfg, q, PULL))
        if not sharded:
            continue
        for placement, telemetry in (("replicated", False), ("edge_sharded", False),
                                     ("edge_sharded", True)):
            suffix = "_tele" if telemetry else ""
            yield (f"trace:{name}/sharded_{placement}{suffix}_step{tag}",
                   _sharded(program, g, pack, cfg, q, dev, placement, telemetry))


def check_catalog(programs: Optional[dict] = None, scale: int = 6,
                  sharded: bool = True, device="cuda", graph=None,
                  seconds: Optional[dict] = None):
    """Run the trace backend over every catalog entry point. Returns
    (findings, n_entries_checked); `seconds`, when given, gets each entry's
    host seconds."""
    findings: list[Finding] = []
    n = 0
    for entry, make in catalog_entries(programs, scale, sharded, device, graph):
        t0 = time.perf_counter()
        findings.extend(check_step(entry, make))
        if seconds is not None:
            seconds[entry] = time.perf_counter() - t0
        n += 1
    return findings, n

