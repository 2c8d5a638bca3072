"""Slot scheduler: continuous batching of graph point queries.

Port of `repro.serving.scheduler` on the port's batched engine
(`serving/batch_engine.py`). The analogy to SIMD-X JIT task management is
direct: a bounded static structure (S query lanes per algorithm, fixed
shapes) absorbs an irregular request stream (arrivals of arbitrary sources
and algorithms), with overflow handled by a bounded queue + backpressure
instead of device-side reallocation.

Pieces:

  * `AlgoPool` — S lanes of `batch_engine.BatchState` for ONE program.
    Admission writes a freshly initialized query into a done lane's
    columns; one `step()` advances every live lane one iteration; harvest
    extracts converged lanes and frees them. Lanes converge and are
    recycled MID-FLIGHT — queries never wait for the batch.
  * `GraphServer` — per-algorithm pools behind weighted per-(tenant, algo)
    request queues (`submit` returns None when a queue share is full —
    backpressure for the caller to retry/shed), fronted by the LRU
    `ResultCache`: a hit completes the request without touching a pool.

Exactness note: a lane admitted into a half-busy pool sees consensus
push/pull decisions influenced by its batch-mates, so its mode *sequence*
can differ from a solo run; results are still bit-identical for the
idempotent/min programs and pull-only programs served here (see
batch_engine's module docstring for the argument).

Admission fairness: requests queue per (TENANT, ALGORITHM) and each queue
owns a weighted share of the total queue budget (`weights=` per algorithm x
`tenant_weights=` per tenant). Free lanes are dealt round-robin across an
algorithm's tenant queues, resuming after the last-served tenant.

Host reads. The reference's pool read `done` for `free_lanes` and
`harvest` and let the step read `gmode`; on a card each is a blocking
copy. A pool here keeps a host mirror of one packed (done, it, gmode) read
(`batch_engine.pool_flags`, counted in `HOST_READS["pool"]`): every write
to the state (a step, an admission, a preemption, a resume) clears it, and
the next use reads it again — one read a pool step, plus one after a round
of admissions. Harvest gathers the round's converged lanes with one
`index_select` and one device-to-host copy a field.

Telemetry (`telemetry=True` / `trace=`, DESIGN.md §12): the server owns a
`repro_torch.obs.Observability` — request-lifecycle spans, per-pool
latency/volume histograms, and the engines' cumulative `BatchState.tele`
counters, read back as ONE packed int64 vector per live pool per step
(`_pack_pump` through the counted `device_fetch`) plus one mode-trace fetch
per yielding harvest. Disabled (the default), every hook is a no-op and no
telemetry transfer is ever issued; `stats()` documents the read-only schema.

SLO serving (DESIGN.md §13): `submit(deadline_ms=...)` attaches a per-query
deadline that is accounted end-to-end; a `slo=SLOPolicy(...)` additionally
drops hopeless queued queries at admission, routes overflow residual-push
queries to a loosened-tolerance degraded shadow pool under queue pressure,
and preempts long-resident lanes — parking their metadata columns (host
numpy) in the result cache and resuming the fixpoint later via
`reseed_from_residuals`.

Consensus cohorts (`cohorts={'algo': k}`): an algorithm's slot budget is
split across k leaf pools, each with its own push/pull consensus vote.

Streaming graphs: constructed with `delta_cap > 0` the server owns a
`repro_torch.streaming.StreamingGraph`; `apply_updates` absorbs an
edge-update batch, swaps the overlaid views into every pool (each pool
builds its step on the new views), selectively invalidates the LRU by the
reverse-reachability test (refreshing dirty entries incrementally where the
program's contract allows), resumes in-flight residual-push lanes from
corrected residuals and restarts the other dirtied in-flight lanes
(DESIGN.md §8).

Sharded pools (`mesh=`, `placements=`, DESIGN.md §9): an algorithm named in
`placements` runs a `placement.ShardedAlgoPool` on the server's mesh
(`sharded.make_serving_mesh`) behind the same pool contract; its packed read
covers every shard, still one a pool step.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.acc import ACCProgram
from repro_torch.core.engine import EngineConfig
from repro_torch.graph import partition
from repro_torch.graph.csr import EdgeDelta, Graph, live_degrees
from repro_torch.graph.packing import EllPack
from repro_torch.interop import tensor_from_numpy
from repro_torch.obs import (
    MODE_NAMES,
    SLO_FIELDS,
    TELE_COMPACT_DENSE,
    TELE_COMPACT_HITS,
    TELE_LEN,
    TELE_MASKED_DENSE,
    Observability,
    default_count_buckets,
    default_latency_buckets,
    device_fetch,
    iters_from_trace,
    skew_ratio,
    tele_dict,
)
from repro_torch.serving import batch_engine as B
from repro_torch.serving.cache import CachedEntry, ResultCache, make_key, served_result
from repro_torch.serving.slo import SLOPolicy, degraded_variant
from repro_torch.streaming import incremental as INC

class QueueFull(Exception):
    """Raised by `submit(..., strict=True)` when the request queue is full."""


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    algo: str
    source: int
    tenant: str = "default"
    #: absolute deadline on the server's monotonic clock, or None — set by
    #: `submit(deadline_ms=...)` (DESIGN.md §13)
    deadline_t: Optional[float] = None
    #: `time.monotonic()` at the request's latest enqueue (its submit, or
    #: a preemption's re-queue): admission counts the wait since
    queued_t: float = 0.0


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    algo: str
    source: int
    result: Optional[np.ndarray]  # (n,) primary field; None when dropped
    iterations: int
    from_cache: bool
    #: graph version the result is valid for
    graph_version: int = 0
    tenant: str = "default"
    # -- SLO outcome (DESIGN.md §13) ------------------------------------
    #: finished (or was dropped) after its deadline passed
    deadline_missed: bool = False
    #: shed by policy without a result (`result is None`)
    dropped: bool = False
    #: served from the loosened-tolerance degraded shadow pool
    degraded: bool = False
    #: was preempted at least once before completing
    preempted: bool = False


def default_config(g: Graph, max_iters: int = 4096) -> EngineConfig:
    """Serving-friendly engine config: full frontier cap (dense masks can't
    overflow), a modest push edge budget (the consensus controller pulls on
    heavy iterations anyway, so a lean push buffer keeps light iterations
    cheap)."""
    n, m = g.n_nodes, g.n_edges
    return EngineConfig(frontier_cap=n, edge_cap=max(1, min(m, 2 * n)),
                        max_iters=max_iters)


#: bounded length of a pool's per-iteration telemetry log (`iter_log`) — a
#: lane resident longer than this loses its OLDEST per-iteration samples
#: (the span's `iters` list keeps alignment via None gaps; see
#: `GraphServer._complete_span`)
OBS_LOG_LEN = 512


def _pack_pump(st: B.BatchState) -> torch.Tensor:
    """Pack one pump's pool telemetry into ONE int64 vector so the
    scheduler's per-iteration log costs a single device->host transfer per
    pool per step: [gmode, union_fe, overflow, live_lanes, tele(TELE_LEN +
    n_shards — the named counters followed by the per-shard scan-volume
    plane), per-lane frontier counts(S)]. int64, as the port's counters are
    (the reference's int32 wraps at RMAT scale 22); `log_iter` splits the
    variable-width tele block by the fetched length."""
    i64 = torch.int64
    head = torch.stack([st.gmode.to(i64), st.union_fe.to(i64),
                        st.overflow.to(i64), (~st.done).sum().to(i64)])
    tele = (st.tele if st.tele is not None
            else torch.zeros((TELE_LEN,), dtype=i64, device=head.device))
    return torch.cat([head, tele.to(i64), st.count.to(i64)])


def _put(t: torch.Tensor, lane: int, value) -> torch.Tensor:
    """A copy of the (S, ...) tensor `t` with row `lane` set to `value`
    (the small per-lane vectors; a fresh state's share one zeros tensor)."""
    out = t.clone()
    out[lane] = value
    return out


def _lane_rows(plane: torch.Tensor, n: int) -> list:
    """Each lane's (n,) column of an (n+1, Q) plane as its own host array."""
    return [obs.host_copy(row) for row in plane[:n].T.contiguous()]


def _lane_plane(cols: list, scratch: float, dev: torch.device) -> torch.Tensor:
    """An (n+1, Q) plane on `dev` from Q cached (n,) host columns, its
    scratch row set to `scratch`. The columns go over as the rows of one
    contiguous host stack and are transposed on the device (a host stack
    along the lane axis writes every element at a stride of Q)."""
    rows = torch.from_numpy(np.stack(cols)).to(dev)                  # (Q, n)
    tail = torch.full((rows.shape[0], 1), scratch, dtype=rows.dtype, device=dev)
    return torch.cat([rows, tail], 1).T.contiguous()


class _LanePool:
    """Lane bookkeeping of a pool — the scheduler drives pools through
    exactly this contract. Subclasses provide `state`, `lane_rid`, `slots`,
    `program`, `result_field`, `cfg`, `g`, `live_deg`, and `_step(st, gmode)`."""

    #: telemetry flag + bounded per-iteration log, set up by `_init_obs` in
    #: each concrete pool's ctor
    telemetry = False

    def _init_obs(self, telemetry: bool) -> None:
        self.telemetry = bool(telemetry)
        self.iter_log: deque = deque(maxlen=OBS_LOG_LEN)
        #: pool step count at each lane's (re)admission — the lane's
        #: iteration i ran during pool step `lane_admit_step[lane] + 1 + i`
        self.lane_admit_step: List[int] = [0] * self.slots
        #: host wall clock (time.monotonic) at each lane's (re)admission —
        #: the scheduler's residency measure for SLO decisions
        self.lane_admit_t: List[float] = [0.0] * self.slots
        #: iterations a lane had ALREADY run when (re)admitted — 0 normally,
        #: the saved iteration count for a preempt-resumed lane
        self.lane_it_base: List[int] = [0] * self.slots
        #: EWMA of harvested lanes' resident seconds — the policy's
        #: service-time estimate for hopeless-drop / preemption triggers
        self.ewma_resident_s: Optional[float] = None
        #: push/pull decision audit log (DESIGN.md §14): one host record per
        #: executed iteration, derived from the packed sample `log_iter`
        #: already fetched — zero extra transfers
        self.audit_log: deque = deque(maxlen=OBS_LOG_LEN)
        self._audit_prev: Optional[np.ndarray] = None
        self._last_gmode: Optional[int] = None
        #: the consensus controller's volume threshold (batch_engine
        #: `_consensus_mode`: heavy when union_fe > alpha * n_edges or
        #: union_fe > edge_cap or overflow)
        self._audit_alpha_edges = int(self.cfg.alpha * self.g.n_edges)

    # -- the host mirror of (done, it, gmode) ---------------------------------

    def _set_state(self, st: B.BatchState) -> None:
        """Install a new state; the host mirror is read again at next use."""
        self.state = st
        self._mirror = None

    def _flags(self) -> tuple:
        """(done per lane, iterations per lane, gmode) of the current state,
        read once after each write (`batch_engine.pool_flags`)."""
        if self._mirror is None:
            self._mirror = B.pool_flags(self.state)
        return self._mirror

    # -- telemetry -------------------------------------------------------------

    def log_iter(self) -> dict:
        """Record one executed pool iteration (call right after `step()`):
        one `device_fetch` of the packed sample, appended to `iter_log`.
        The tele block splits by fetched length into the named counters and
        the per-shard scan plane; the same sample also feeds the decision
        audit log."""
        packed = device_fetch(self._pump_sample())
        tele_w = len(packed) - 4 - self.slots
        entry = {
            "step": self.steps,
            "gmode": int(packed[0]),
            "union_fe": int(packed[1]),
            "overflow": bool(packed[2]),
            "live": int(packed[3]),
            "tele": packed[4:4 + TELE_LEN],
            "shard_edges": packed[4 + TELE_LEN:4 + tele_w],
            "counts": packed[4 + tele_w:],
        }
        self.iter_log.append(entry)
        self._audit_iter(entry)
        return entry

    def _audit_iter(self, entry: dict) -> None:
        """Append this iteration's consensus decision record: the inputs
        the controller saw (post-step union volume vs the alpha / edge-cap
        thresholds, overflow) and the mode it chose for the NEXT iteration,
        plus compact-vs-dense and masked-dense fallback deltas recovered by
        differencing consecutive cumulative tele samples (host ints)."""
        tele = np.asarray(entry["tele"], np.int64)
        prev = self._audit_prev
        d = tele - prev if prev is not None else tele
        self._audit_prev = tele
        gmode = entry["gmode"]
        switched = (self._last_gmode is not None
                    and gmode != self._last_gmode)
        self._last_gmode = gmode
        self.audit_log.append({
            "step": entry["step"],
            "union_fe": entry["union_fe"],
            "overflow": entry["overflow"],
            "alpha_threshold": self._audit_alpha_edges,
            "edge_cap": int(self.cfg.edge_cap),
            "mode": MODE_NAMES.get(gmode, str(gmode)),
            "switched": bool(switched),
            "compact_hits_d": int(d[TELE_COMPACT_HITS]),
            "compact_dense_d": int(d[TELE_COMPACT_DENSE]),
            "masked_dense_d": int(d[TELE_MASKED_DENSE]),
        })

    def _pump_sample(self) -> torch.Tensor:
        """The packed telemetry sample of the current state (`_pack_pump`)."""
        return _pack_pump(self.state)

    def mode_trace(self) -> torch.Tensor:
        """(S, trace_len) mode trace of every lane."""
        return self.state.mode_trace

    def meta_fields(self) -> tuple:
        """The names of the metadata fields the pool's program carries."""
        return tuple(self.state.m)

    # -- lanes -------------------------------------------------------------------

    def free_lanes(self) -> List[int]:
        done = self._flags()[0]
        return [i for i in range(self.slots)
                if self.lane_rid[i] is None and done[i]]

    def live(self) -> bool:
        return any(r is not None for r in self.lane_rid)

    def step(self) -> None:
        """Advance every live lane one iteration, on the mirrored gmode."""
        if self.live():
            gmode = self._flags()[2]
            self._set_state(self._step(self.state, gmode))
            self.steps += 1

    def _admit_state(self, lane: int, source: int) -> None:
        """Write a freshly initialized query into `lane` of the state."""
        self._set_state(_admit_lane(self.program, self.g, self.cfg, self.state,
                                    source, lane, deg=self.live_deg))

    def admit(self, lane: int, rid: int, source: int) -> None:
        assert self.lane_rid[lane] is None
        self._admit_state(lane, source)
        self.lane_rid[lane] = rid
        self.lane_admit_step[lane] = self.steps
        self.lane_admit_t[lane] = time.monotonic()
        self.lane_it_base[lane] = 0
        self.engine_queries += 1

    def readmit(self, lane: int, source: int) -> None:
        """Re-initialize a LIVE lane's query from scratch (same rid, same
        lane — the streaming update's restart of a dirtied query)."""
        assert self.lane_rid[lane] is not None
        self._admit_state(lane, source)
        self.lane_admit_step[lane] = self.steps
        self.lane_admit_t[lane] = time.monotonic()
        self.lane_it_base[lane] = 0
        self.engine_queries += 1

    def observe_resident(self, resident_s: float) -> None:
        """Fold one harvested lane's residency into the pool's EWMA
        service-time estimate (host floats only)."""
        prev = self.ewma_resident_s
        self.ewma_resident_s = (
            resident_s if prev is None else 0.8 * prev + 0.2 * resident_s)

    def preempt(self, lane: int) -> dict:
        """Evict a LIVE lane mid-run, returning its full metadata columns,
        executed iteration count, and mode-trace row (host numpy) so the
        scheduler can park the partial state and `admit_resume` it later —
        in this pool or in a reference pool, which takes the same dict.

        Only meaningful for residual-push programs, whose invariant holds at
        every iteration: the settled (rank, resid) mass is preserved, so the
        evicted query RESUMES its fixpoint instead of restarting (DESIGN.md
        §13). The lane itself is returned to the free pool (done, inactive,
        empty frontier) and the pool's consensus inputs are recomputed
        without the victim's frontier."""
        assert self.lane_rid[lane] is not None
        st = self.state
        saved = {
            "planes": {k: obs.host_copy(st.m[k][:, lane]) for k in st.m},
            "it": int(self._flags()[1][lane]),
            "trace": obs.host_copy(st.mode_trace[lane]),
        }
        st.active[:, lane] = False
        st = st._replace(done=_put(st.done, lane, True),
                         count=_put(st.count, lane, 0))
        if st.hot is not None:
            st.hot[:, lane] = False
        union_fe, overflow = B._union_volume(self.g.out, self.cfg, st.active)
        st = st._replace(union_fe=union_fe, overflow=overflow)
        st = st._replace(gmode=B._consensus_mode(
            self.program, self.cfg, self.g.n_edges, st))
        self._set_state(st)
        self.lane_rid[lane] = None
        return saved

    def admit_resume(self, lane: int, rid: int, saved: dict) -> None:
        """Re-admit a preempted query into a free lane from its saved
        partial state (`preempt`'s dict of host numpy, from this package's
        pool or the reference's): write the metadata columns back, restore
        the iteration count and mode trace, and re-derive the frontier from
        the FULL residual field via `reseed_from_residuals`. Other live
        lanes' recomputed frontiers equal their current ones (the active set
        of a residual program is a pure function of the metadata), so this
        perturbs nobody else."""
        assert self.lane_rid[lane] is None
        st = self.state
        dev = st.done.device
        for k in st.m:
            st.m[k][:, lane] = tensor_from_numpy(saved["planes"][k], dev)
        trace = tensor_from_numpy(saved["trace"], dev)
        st = st._replace(
            done=_put(st.done, lane, False),
            it=_put(st.it, lane, int(saved["it"])),
            mode_trace=_put(st.mode_trace, lane, trace),
        )
        st = INC.reseed_from_residuals(self.program, self.cfg, self.g, st, st.m)
        self._set_state(st)
        self.lane_rid[lane] = rid
        self.lane_admit_step[lane] = self.steps
        self.lane_admit_t[lane] = time.monotonic()
        self.lane_it_base[lane] = int(saved["it"])
        self.engine_queries += 1

    def _refresh_live_deg(self) -> None:
        """The live-degree vector is constant per graph version — count it
        once here (ctor / set_graph) and feed it to every admission."""
        self.live_deg = live_degrees(self.g.out, self.delta)

    def resume_residual(self, sg, report) -> int:
        """RESUME every live lane of a residual-push pool across a streaming
        update: correct the residual planes along the changed adjacency
        columns (`streaming.residual_correct` — valid mid-run) and reseed
        live lanes' frontiers from the full corrected residual field. Dirty
        in-flight queries keep their settled mass instead of restarting;
        clean lanes' corrections are identically zero, so their
        trajectories continue bitwise unchanged. Returns the number of live
        lanes left un-converged (one read of the lane counts)."""
        m = INC.residual_correct(self.program, sg, self.state.m, report)
        st = INC.reseed_from_residuals(self.program, self.cfg, self.g, self.state, m)
        self._set_state(st)
        live = [lane for lane, rid in enumerate(self.lane_rid) if rid is not None]
        if not live:
            return 0
        counts = obs.host_flags(st.count)
        return sum(counts[lane] > 0 for lane in live)

    def _reset_masked_pull_cache(self) -> None:
        """Masked-pull partial caches were computed against the old graph,
        so rebuild them at identity (an overflow rebuild can change slice
        ROW COUNTS) and force the next pull dense."""
        st = self.state
        if not (self.cfg.masked_pull and st.pull_dense is not None):
            return
        ident = self.program.combiner.identity_value()
        prim = st.m[self.program.primary]
        pseg = tuple(torch.full((s.rows, self.slots), ident, dtype=prim.dtype,
                                device=prim.device) for s in self.pack.slices)
        self._set_state(st._replace(
            pseg=pseg, pull_dense=B._full(True, torch.bool, prim.device)))

    #: extra metadata planes to harvest alongside the result — residual
    #: pools set this to their residual field so cached entries carry the
    #: full (rank, resid) resumable state
    cache_extra_fields: tuple = ()

    def harvest(self) -> List[tuple]:
        """(lane, rid, result, iterations, extras) for every converged lane;
        `extras` is a {field: (n,) np} dict of `cache_extra_fields` planes
        (empty for the plain min/max/pull pools). The converged lanes'
        columns are gathered in one `index_select` a field; each lane's row
        then goes to the host on its own, so every result owns its memory
        (a cached or returned result holds no other lane's block)."""
        if not self.live():
            return []
        done, its, _gmode = self._flags()
        lanes = [lane for lane, rid in enumerate(self.lane_rid)
                 if rid is not None and done[lane]]
        if not lanes:
            return []
        idx = torch.tensor(lanes, dtype=torch.long, device=self.state.done.device)
        cols = {}
        for f in (self.result_field, *self.cache_extra_fields):
            block = self.state.m[f].index_select(1, idx)[:-1].T.contiguous()
            cols[f] = [obs.host_copy(row) for row in block]
        out = []
        for j, lane in enumerate(lanes):
            extras = {f: cols[f][j] for f in self.cache_extra_fields}
            out.append((lane, self.lane_rid[lane], cols[self.result_field][j],
                        its[lane], extras))
            self.lane_rid[lane] = None
        return out


class AlgoPool(_LanePool):
    """Fixed query slots for one ACC program over one graph."""

    def __init__(self, name: str, program: ACCProgram, g: Graph, pack: EllPack,
                 cfg: EngineConfig, slots: int, result_field: Optional[str] = None,
                 delta: Optional[EdgeDelta] = None, telemetry: bool = False):
        assert slots >= 1
        self.name = name
        self.program = program
        # served field defaults to the program's declared 'result' param
        # (kcore serves 'alive', mis 'state' — not their push-plane
        # primaries), falling back to the primary
        self.result_field = result_field or program.param(
            "result", program.primary)
        self.g = g
        self.pack = pack
        self.delta = delta
        self.cfg = cfg
        self.slots = slots
        self.lane_rid: List[Optional[int]] = [None] * slots
        # all lanes start inactive (done=True, empty frontiers); the mirror
        # starts from what was asked for, with no read
        self._refresh_live_deg()
        self.state = B.init_batch(program, g, cfg, [0] * slots,
                                  done=[True] * slots, pack=pack, deg=self.live_deg,
                                  telemetry=telemetry)
        self._mirror = ([True] * slots, [0] * slots, None)
        self._step = B.make_batched_step(program, g, pack, cfg, delta)
        self.engine_queries = 0
        self.steps = 0
        self._init_obs(telemetry)
        #: extra cache-key params; single-device results are the bitwise
        #: reference, so no distinguishing params
        self.cache_params: tuple = ()
        # pools whose program declares a resume contract cache its
        # `resume_fields` beyond the result plane (residual pools carry
        # (rank, resid))
        self.cache_extra_fields = tuple(
            f for f in INC.resume_fields(program) if f != self.result_field)

    # -- streaming support ---------------------------------------------------

    def set_graph(self, g: Graph, pack: EllPack,
                  delta: Optional[EdgeDelta]) -> None:
        """Swap in updated overlay views: the live degrees are counted again,
        the step is built on the new views, and the masked-pull caches are
        reset (`_reset_masked_pull_cache`)."""
        self.g, self.pack, self.delta = g, pack, delta
        self._refresh_live_deg()
        self._step = B.make_batched_step(self.program, g, pack, self.cfg, delta)
        self._reset_masked_pull_cache()


def _admit_lane(program, g, cfg, st: B.BatchState, source, lane,
                deg: torch.Tensor, check_caps: bool = True,
                consensus: bool = True) -> B.BatchState:
    """Write one freshly initialized query into lane `lane` (`deg`: the
    graph's live degrees, counted once a pool). The lane's columns of the
    (n+1, S) planes are written in place (a column, not the plane); the
    per-lane vectors are copied.

    `consensus=False` leaves the union volume and gmode to the caller: a
    sharded pool sets them from every query shard's lanes, and its
    edge-sharded admission passes a bare `B.GraphDims` as `g` (CSR-free)."""
    one = B.init_batch(program, g, cfg, [int(source)], deg=deg, check_caps=check_caps)
    for k in st.m:
        st.m[k][:, lane] = one.m[k][:, 0]
    st.active[:, lane] = one.active[:, 0]
    if st.hot is not None:
        st.hot[:, lane] = True
    st = st._replace(
        count=_put(st.count, lane, one.count[0]),
        mode=_put(st.mode, lane, one.mode[0]),
        it=_put(st.it, lane, 0),
        done=_put(st.done, lane, one.done[0]),
        push_iters=_put(st.push_iters, lane, 0),
        pull_iters=_put(st.pull_iters, lane, 0),
        switches=_put(st.switches, lane, 0),
        mode_trace=_put(st.mode_trace, lane, one.mode_trace[0]),
    )
    if cfg.masked_pull and st.pull_dense is not None:
        # the new lane has no valid partial cache yet
        st = st._replace(pull_dense=B._full(True, torch.bool, st.done.device))
    if not consensus:
        return st
    union_fe, overflow = B._union_volume(g.out, cfg, st.active)
    st = st._replace(union_fe=union_fe, overflow=overflow)
    return st._replace(gmode=B._consensus_mode(program, cfg, g.n_edges, st))


class GraphServer:
    """Batched multi-query serving: cache -> weighted fair queues -> pools."""

    def __init__(
        self,
        g: Graph,
        pack: EllPack,
        programs: Dict[str, ACCProgram],
        slots: "int | Dict[str, int]" = 8,
        cfg: Optional[EngineConfig] = None,
        queue_cap: int = 256,
        cache_capacity: int = 1024,
        graph_version: int = 0,
        result_fields: Optional[Dict[str, str]] = None,
        weights: Optional[Dict[str, float]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        delta_cap: int = 0,
        mesh=None,
        placements: Optional[Dict[str, object]] = None,
        telemetry: bool = False,
        trace=None,
        obs: Optional[Observability] = None,
        cohorts: Optional[Dict[str, int]] = None,
        slo: Optional[SLOPolicy] = None,
        cohort_affinity: Optional[Dict[str, Sequence[int]]] = None,
    ):
        cfg = cfg or default_config(g)
        self.cfg = cfg
        # one switch for the whole stack (DESIGN.md §12): a trace sink or
        # an injected Observability implies enabled; disabled servers carry
        # tele=None engine states and never call device_fetch
        self.obs = obs if obs is not None else Observability(
            enabled=telemetry, trace=trace)
        telemetry = self.obs.enabled
        delta = None
        self.sg = None
        if delta_cap > 0:
            from repro_torch.streaming import StreamingGraph

            # the server serves the overlay's views; `pack` may be None
            self.sg = StreamingGraph(g, delta_cap=delta_cap)
            self.sg.version = graph_version
            g, pack, delta = self.sg.graph, self.sg.pack, self.sg.delta
        self.g = g
        self.graph_version = graph_version
        self.queue_cap = queue_cap
        self.cache = ResultCache(cache_capacity)
        self.mesh = mesh
        placements = placements or {}
        assert not placements or mesh is not None, (
            "placements require a serving mesh "
            "(serving.placement.make_serving_mesh)")
        result_fields = result_fields or {}
        # consensus cohorts (DESIGN.md §13): an algorithm's slot budget
        # splits across k leaf pools with INDEPENDENT push/pull consensus,
        # a heavy pull-mode query drags only its own narrow cohort, not
        # every lane
        self.cohorts = {
            name: int((cohorts or {}).get(name, 1)) for name in programs}
        self.pool_groups: Dict[str, List[AlgoPool]] = {}
        for name, prog in programs.items():
            s = slots[name] if isinstance(slots, dict) else slots
            k = self.cohorts[name]
            assert k >= 1, (name, k)
            if name in placements:
                from repro_torch.serving.placement import ShardedAlgoPool

                assert k == 1, (
                    "cohorts split a single-device pool; sharded pools "
                    "isolate via Placement(consensus='local') instead")
                self.pool_groups[name] = [ShardedAlgoPool(
                    name, prog, g, pack, cfg, s, mesh, placements[name],
                    result_field=result_fields.get(name), delta=delta,
                    telemetry=telemetry)]
                continue
            assert s % k == 0, (
                f"slots={s} for {name!r} must divide into {k} cohorts")
            self.pool_groups[name] = [
                AlgoPool(name if k == 1 else f"{name}#c{i}", prog, g, pack,
                         cfg, s // k, result_field=result_fields.get(name),
                         delta=delta, telemetry=telemetry)
                for i in range(k)]
        #: primary leaf per algorithm — the stable lookup surface
        #: (cache_params, program, result_field are identical across a
        #: group); cohorted groups' full lane sets live in `pool_groups`
        self.pools: Dict[str, AlgoPool] = {
            name: grp[0] for name, grp in self.pool_groups.items()}
        # SLO policy state (DESIGN.md §13)
        self.slo = slo
        self.degraded_pools: Dict[str, AlgoPool] = {}
        if slo is not None:
            for name in slo.degrade_algos:
                assert name in programs, name
                dprog = degraded_variant(programs[name], slo.degrade_factor)
                dp = AlgoPool(
                    f"{name}@degraded", dprog, g, pack, cfg,
                    slo.degrade_slots,
                    result_field=result_fields.get(name),
                    delta=delta, telemetry=telemetry,
                )
                # degraded results are NEVER cached (tagged pool, and
                # _harvest_pool skips the put) — the bit-exact key must not
                # serve a loosened-tolerance answer
                dp.cache_params = (("degraded", float(slo.degrade_factor)),)
                self.degraded_pools[name] = dp
        #: always-on SLO outcome counters (stats()["slo"]) — mirrored into
        #: `slo.*` registry counters when telemetry is enabled
        self.slo_counts = {f: 0 for f in SLO_FIELDS}
        self._deadline_t: Dict[int, float] = {}
        #: rid -> times preempted (policy budget) / parked-state cache key
        self._preempt_counts: Dict[int, int] = {}
        self._preempt_saved: Dict[int, tuple] = {}
        self._degraded_rids: set = set()
        # weighted fair queuing at the admission edge: per-(tenant, algo)
        # queues, each owning (algo share) x (tenant share) of the budget
        weights = weights or {}
        self.weights = {name: float(weights.get(name, 1.0)) for name in programs}
        total_w = sum(self.weights.values())
        self.queue_quota = {
            name: max(1, int(queue_cap * w / total_w))
            for name, w in self.weights.items()
        }
        self.tenants = (
            {t: float(w) for t, w in tenant_weights.items()}
            if tenant_weights else {"default": 1.0}
        )
        # `or 1.0`: all-zero declared weights still yield the max(1, ...)
        # floor share below instead of a ZeroDivisionError
        total_t = sum(self.tenants.values()) or 1.0
        self.tenant_quota = {
            (name, t): max(1, int(self.queue_quota[name] * tw / total_t))
            for name in programs for t, tw in self.tenants.items()
        }
        # tenant -> cohort affinity (DESIGN.md §13): a listed tenant only
        # admits into leaf ordinals `i % k` of each algorithm's k-leaf
        # cohort group; unlisted tenants land anywhere. Confining a heavy
        # best-effort tenant to one cohort is what lets the step cadence
        # (SLOPolicy.cohort_burst / best_effort_stride) starve only that
        # leaf instead of every lane in the pool.
        self.cohort_affinity: Dict[str, Tuple[int, ...]] = {}
        for t, idxs in (cohort_affinity or {}).items():
            assert t in self.tenants, (
                f"cohort_affinity tenant {t!r} not declared "
                f"(declared: {sorted(self.tenants)})")
            norm = tuple(sorted({int(i) for i in idxs}))
            assert norm, f"cohort_affinity for {t!r} must list >= 1 cohort"
            self.cohort_affinity[t] = norm
        #: pump round counter — the clock `best_effort_stride` gates on
        self._round = 0
        self.queues: Dict[str, Dict[str, deque]] = {
            name: {t: deque() for t in self.tenants} for name in programs
        }
        #: per-algo rotation pointer into the tenant list — dealing resumes
        #: AFTER the last-served tenant instead of restarting at the first,
        #: so a tenant whose weight rounds to the minimum share still gets a
        #: lane every rotation (starvation fix, tests/test_serving.py)
        self._rr: Dict[str, int] = {name: 0 for name in programs}
        self._next_rid = 0
        self._inflight_sources: Dict[int, int] = {}
        self._inflight_tenants: Dict[int, str] = {}
        #: rid -> submit wall clock, kept only while the health monitor is
        #: on — feeds end-to-end latency into its P² estimators
        self._submit_t: Dict[int, float] = {}
        self.completions: List[Completion] = []
        self.rejected = 0
        self.update_log: List[dict] = []
        #: [seconds queued, admissions] summed over every admission from
        #: the queues: host floats, kept with telemetry off too
        self._queue_wait = [0.0, 0]

    # -- request side --------------------------------------------------------

    def submit(self, algo: str, source: int, strict: bool = False,
               tenant: str = "default",
               deadline_ms: Optional[float] = None) -> Optional[int]:
        """Enqueue a query; returns its rid, or None when the (tenant, algo)
        queue share is full (backpressure — caller sheds or retries;
        `strict=True` raises). One tenant flooding one algorithm exhausts
        only its own share of that algorithm's budget; every other
        (tenant, algo) share is untouched.

        `deadline_ms` attaches a latency SLO: the completion (and span) is
        flagged `deadline_missed` if it finishes late, and an active
        `SLOPolicy` may drop/degrade/preempt around it (DESIGN.md §13). A
        deadline already expired at submit completes immediately as
        `dropped` under a drop policy (the rid is still returned — the
        outcome is in the completion)."""
        if algo not in self.pools:
            raise KeyError(f"no pool for algorithm {algo!r}")
        if tenant not in self.tenants:
            raise KeyError(
                f"unknown tenant {tenant!r} (declared: {sorted(self.tenants)})")
        now = time.monotonic()
        deadline_t = (None if deadline_ms is None
                      else now + float(deadline_ms) / 1e3)
        rid = self._next_rid
        key = make_key(self.graph_version, algo, source,
                       self.pools[algo].cache_params)
        hit = self.cache.get(key)
        reg = self.obs.registry
        reg.counter("requests_total").inc()
        if hit is not None:
            self._next_rid += 1
            missed = deadline_t is not None and now > deadline_t
            if missed:
                self._count_slo("deadline_missed")
            reg.counter("cache_hits_total").inc()
            self._rec("cache_hit", rid=rid, algo=algo, source=int(source))
            self.obs.health.on_complete(0.0, deadline_missed=missed)
            tr = self.obs.tracer
            tr.begin(rid, algo, int(source), tenant, self.graph_version)
            tr.complete(rid, from_cache=True, iterations=0,
                        slo=self._span_slo(deadline_t, missed=missed))
            self.completions.append(Completion(
                rid=rid, algo=algo, source=int(source),
                result=served_result(hit),
                iterations=0, from_cache=True,
                graph_version=self.graph_version, tenant=tenant,
                deadline_missed=missed,
            ))
            return rid
        if (self.slo is not None and self.slo.drop_expired
                and deadline_t is not None and now >= deadline_t):
            self._next_rid += 1
            if self.obs.health.enabled:
                self._submit_t[rid] = now
            self.obs.tracer.begin(rid, algo, int(source), tenant,
                                  self.graph_version)
            self._drop_request(Request(
                rid=rid, algo=algo, source=int(source), tenant=tenant,
                deadline_t=deadline_t))
            return rid
        if len(self.queues[algo][tenant]) >= self.tenant_quota[(algo, tenant)]:
            self.rejected += 1
            reg.counter("rejected_total").inc()
            if strict:
                raise QueueFull(
                    f"queue for tenant {tenant!r} of {algo!r} at its share "
                    f"{self.tenant_quota[(algo, tenant)]} of capacity "
                    f"{self.queue_cap}")
            return None
        self._next_rid += 1
        if deadline_t is not None:
            self._deadline_t[rid] = deadline_t
        if self.obs.health.enabled:
            self._submit_t[rid] = now
        self.obs.tracer.begin(rid, algo, int(source), tenant,
                              self.graph_version, t=now)
        self.queues[algo][tenant].append(
            Request(rid=rid, algo=algo, source=int(source), tenant=tenant,
                    deadline_t=deadline_t, queued_t=now))
        return rid

    # -- SLO bookkeeping -----------------------------------------------------

    def _count_slo(self, field: str) -> None:
        self.slo_counts[field] += 1
        self.obs.registry.counter(f"slo.{field}").inc()

    # -- flight recorder / health (DESIGN.md §14) ----------------------------

    def _rec(self, kind: str, **payload) -> None:
        """Record one flight-recorder event (free when unarmed; host-only
        when armed — never reads device state)."""
        r = self.obs.flight
        if r is not None:
            r.record(kind, **payload)

    def _health_complete(self, rid: int, now: float, *, missed: bool,
                         dropped: bool = False) -> None:
        """Feed one finished request into the health monitor's latency
        estimators and windowed gauges."""
        t0 = self._submit_t.pop(rid, None)
        self.obs.health.on_complete(
            (now - t0) if t0 is not None else 0.0,
            deadline_missed=missed, dropped=dropped)

    def dump_flight_record(self, path: str) -> int:
        """Post-mortem export: write the flight ring to `path` as JSONL
        (scripts/trace_schema.py --flight validates it), after appending one
        `imbalance` summary event per pool group — the latest per-shard
        scan-volume plane and its skew ratio, so a dump carries the workload
        profile alongside the event timeline. Returns events written; an
        unarmed server writes an empty file (callers may ship the path
        unconditionally)."""
        rec = self.obs.flight
        if rec is None:
            open(path, "w").close()
            return 0
        for name, grp in self.pool_groups.items():
            plane = self._group_plane(grp)
            if plane.size:
                rec.record("imbalance", pool=name,
                           shard_edges=[int(x) for x in plane],
                           skew=round(skew_ratio(plane), 4))
        return rec.dump(path)

    @staticmethod
    def _group_plane(grp: List["AlgoPool"]) -> np.ndarray:
        """A pool group's per-shard scan plane: the latest cumulative plane
        of each cohort leaf, concatenated (sharded groups have one leaf
        whose plane is the mesh axis; cohort groups expose per-cohort scan
        volumes). Empty when telemetry is off or nothing has stepped."""
        parts = [np.asarray(q.iter_log[-1]["shard_edges"], np.int64)
                 for q in grp if getattr(q, "iter_log", None)]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.int64))

    @staticmethod
    def _span_slo(deadline_t: Optional[float], *, missed: bool = False,
                  dropped: bool = False, degraded: bool = False,
                  preempted: bool = False) -> Optional[dict]:
        """Span `slo` payload; None when the request had no deadline and no
        policy action touched it (keeps pre-SLO traces byte-stable)."""
        if deadline_t is None and not (missed or dropped or degraded
                                       or preempted):
            return None
        return {
            "deadline_s": None if deadline_t is None else round(
                float(deadline_t), 9),
            "deadline_missed": bool(missed),
            "dropped": bool(dropped),
            "degraded": bool(degraded),
            "preempted": bool(preempted),
        }

    def _drop_request(self, req: Request) -> None:
        """Complete a queued (or just-submitted, or just-evicted) request as
        DROPPED: no result, counted, span-closed. Drops imply a missed
        deadline — the policy only sheds work that cannot finish in time."""
        rid = req.rid
        self._count_slo("dropped")
        self._count_slo("deadline_missed")
        self._rec("drop", rid=rid, algo=req.algo, tenant=req.tenant)
        self._health_complete(rid, time.monotonic(), missed=True,
                              dropped=True)
        self._deadline_t.pop(rid, None)
        was_preempted = rid in self._preempt_counts
        self._preempt_counts.pop(rid, None)
        key = self._preempt_saved.pop(rid, None)
        if key is not None:
            self.cache.pop(key)   # parked partial state dies with the query
        self.obs.tracer.complete(
            rid, from_cache=False, iterations=0,
            slo=self._span_slo(req.deadline_t, missed=True, dropped=True,
                               preempted=was_preempted))
        self.completions.append(Completion(
            rid=rid, algo=req.algo, source=req.source, result=None,
            iterations=0, from_cache=False,
            graph_version=self.graph_version, tenant=req.tenant,
            deadline_missed=True, dropped=True, preempted=was_preempted,
        ))

    # -- serving loop --------------------------------------------------------

    def _queued(self) -> int:
        return sum(len(q) for qs in self.queues.values() for q in qs.values())

    def _leaves(self):
        """Every concrete lane pool the scheduling loop drives: each
        algorithm's cohort leaves, then the degraded shadow pools.
        Yields (algo, pool, degraded)."""
        for name, grp in self.pool_groups.items():
            for p in grp:
                yield name, p, False
        for name, p in self.degraded_pools.items():
            yield name, p, True

    def pump(self) -> List[Completion]:
        """One scheduling round per algorithm: SLO admission scan (drop
        expired/hopeless queued queries, maybe preempt a long-resident lane
        for deadline-critical queued work), deal free lanes — interleaved
        across cohort leaves, rotation-fair across tenants — then route
        overflow to the degraded shadow pool under queue pressure; one
        batched step per live leaf, harvest converged lanes. Returns this
        round's completions (drops included). Fairness across algorithms
        comes from the weighted queue shares enforced at submit."""
        n0 = len(self.completions)
        now = time.monotonic()
        for name, grp in self.pool_groups.items():
            if self.slo is not None:
                self._slo_admission_scan(name, grp, now)
                self._maybe_preempt(name, grp, now)
            lanes = self._deal_lanes(grp)
            self._admit_from_queues(name, lanes, degraded=False)
            dp = self.degraded_pools.get(name)
            if dp is not None and self._pressure(name, now):
                dlanes = deque((0, dp, l) for l in dp.free_lanes())
                self._admit_from_queues(name, dlanes, degraded=True)

        new: List[Completion] = []
        self._round += 1
        for name, grp in self.pool_groups.items():
            for ordinal, pool in enumerate(grp):
                self._step_leaf(pool, self._leaf_cadence(name, pool, ordinal))
                new.extend(self._harvest_pool(name, pool, degraded=False))
        for name, dp in self.degraded_pools.items():
            self._step_leaf(dp, 1)
            new.extend(self._harvest_pool(name, dp, degraded=True))
        if self.obs.enabled:
            qd = self._queued()
            self.obs.registry.gauge("queued").set(qd)
            self.obs.health.on_queue_depth(qd)
        self.completions.extend(new)
        return self.completions[n0:]

    def _step_leaf(self, pool: AlgoPool, k: int) -> None:
        """Advance one leaf pool up to `k` batched steps this round (0 = a
        stride-skipped best-effort cohort; >1 = a deadline burst), stopping
        early once nothing is live."""
        for _ in range(k):
            if not pool.live():
                break
            with obs.region("simdx.serve.step"):
                pool.step()
                entry = pool.log_iter() if self.obs.enabled else None
            if entry is not None:
                reg = self.obs.registry
                reg.histogram(f"{pool.name}.union_fe",
                              default_count_buckets()).observe(
                    entry["union_fe"])
                reg.gauge(f"{pool.name}.live_lanes").set(entry["live"])
                # workload-imbalance profile (DESIGN.md §14): per-lane
                # frontier-size distribution + per-shard scan skew, both
                # read from the sample log_iter already fetched
                fhist = reg.histogram(f"{pool.name}.frontier",
                                      default_count_buckets())
                for c in entry["counts"]:
                    if c > 0:
                        fhist.observe(int(c))
                if len(entry["shard_edges"]):
                    reg.gauge(f"{pool.name}.shard_skew").set(
                        skew_ratio(entry["shard_edges"]))
                audit = pool.audit_log[-1] if pool.audit_log else None
                if audit is not None and self.obs.flight is not None:
                    if audit["switched"]:
                        self._rec("mode_switch", pool=pool.name,
                                  step=audit["step"], mode=audit["mode"],
                                  union_fe=audit["union_fe"])
                    if audit["compact_dense_d"]:
                        self._rec("compact_overflow", pool=pool.name,
                                  step=audit["step"],
                                  n=audit["compact_dense_d"])

    def _leaf_cadence(self, name: str, pool: AlgoPool, ordinal: int) -> int:
        """Steps this cohort leaf gets this round (DESIGN.md §13). The
        measured cost model behind the knobs: a batched step prices by
        ALLOCATED lanes Q (plus an m-bound constant), not by live content,
        and the host backend pumps leaves sequentially with no dispatch
        overlap — so a leaf's only isolation lever is step frequency.
        Deadline-bearing leaves may burst `cohort_burst` steps per round;
        best-effort-only leaves step every `best_effort_stride`-th round.
        Defaults (1/1) reproduce the flat one-step-per-leaf schedule."""
        pol = self.slo
        if pol is None or len(self.pool_groups[name]) <= 1:
            return 1
        burst = max(1, pol.cohort_burst)
        stride = max(1, pol.best_effort_stride)
        if burst == 1 and stride == 1:
            return 1
        if any(rid is not None and rid in self._deadline_t
               for rid in pool.lane_rid):
            return burst
        return 1 if (self._round + ordinal) % stride == 0 else 0

    def _deal_lanes(self, grp: List[AlgoPool]) -> deque:
        """Free lanes of a cohort group as (ordinal, pool, lane) triples,
        interleaved round-robin across leaves so admissions spread load (and
        pull-mode risk) instead of filling one cohort first."""
        per = [deque(p.free_lanes()) for p in grp]
        lanes: deque = deque()
        while any(per):
            for i, (p, q) in enumerate(zip(grp, per)):
                if q:
                    lanes.append((i, p, q.popleft()))
        return lanes

    def _take_lane(self, lanes: deque, tenant: str, k: int,
                   degraded: bool) -> Optional[tuple]:
        """Pop the first dealt lane this tenant may use: any lane when the
        tenant has no cohort affinity (or for the degraded shadow pool —
        a single leaf, no cohorts to pin), else the first whose leaf
        ordinal falls in the tenant's allowed set mod the group size.
        Returns None when no allowed lane remains (the tenant waits)."""
        allowed = None if degraded else self.cohort_affinity.get(tenant)
        if allowed is None:
            return lanes.popleft()
        allow = {i % k for i in allowed}
        for idx, (ordinal, _p, _l) in enumerate(lanes):
            if ordinal in allow:
                item = lanes[idx]
                del lanes[idx]
                return item
        return None

    def _admit_from_queues(self, name: str, lanes: deque,
                           degraded: bool) -> None:
        """Deal `lanes` to this algorithm's tenant queues, resuming the
        rotation AFTER the last-served tenant (`self._rr`): a minimum-share
        tenant is guaranteed a lane every full rotation even when lanes free
        one per pump — restarting at the first tenant each sweep starved
        everyone behind a persistently-backlogged tenant. Affinity-pinned
        tenants only take lanes in their allowed cohorts; a full sweep that
        places nothing (every backlogged tenant pinned away from every
        remaining lane) ends the deal."""
        qs = self.queues[name]
        tl = list(self.tenants)
        k = len(self.pool_groups[name]) if name in self.pool_groups else 1
        while lanes and any(qs.values()):
            placed = False
            for j in range(len(tl)):
                t = tl[(self._rr[name] + j) % len(tl)]
                if not qs[t]:
                    continue
                dealt = self._take_lane(lanes, t, k, degraded)
                if dealt is None:
                    continue
                self._rr[name] = (self._rr[name] + j + 1) % len(tl)
                req = qs[t].popleft()
                _ordinal, pool, lane = dealt
                self._admit_one(pool, lane, req, degraded)
                placed = True
                break
            if not placed:
                break

    def _admit_one(self, pool: AlgoPool, lane: int, req: Request,
                   degraded: bool) -> None:
        with obs.region("simdx.serve.admit"):
            now = time.monotonic()
            self._queue_wait[0] += now - req.queued_t
            self._queue_wait[1] += 1
            rid = req.rid
            resumed = False
            if not degraded and rid in self._preempt_saved:
                key = self._preempt_saved.pop(rid)
                entry = self.cache.pop(key)
                if entry is not None:
                    # resume the fixpoint from the parked partial state instead
                    # of restarting (preemption contract, DESIGN.md §13); a
                    # capacity-evicted entry falls back to a fresh admit
                    pool.admit_resume(lane, rid, {
                        "planes": entry.extras["planes"],
                        "it": entry.extras["it"],
                        "trace": entry.extras["trace"],
                    })
                    resumed = True
            if not resumed:
                pool.admit(lane, rid, req.source)
            self._inflight_sources[rid] = req.source
            self._inflight_tenants[rid] = req.tenant
            self._rec("resume" if resumed else "admit", rid=rid,
                      pool=pool.name, lane=lane, algo=req.algo)
            if degraded:
                self._degraded_rids.add(rid)
                self._count_slo("degraded")
                self._rec("degrade", rid=rid, pool=pool.name)
            self.obs.tracer.mark(rid, "admit", t=now)

    def _group_ewma(self, grp: List[AlgoPool]) -> Optional[float]:
        seen = [p.ewma_resident_s for p in grp
                if p.ewma_resident_s is not None]
        return sum(seen) / len(seen) if seen else None

    def _slo_admission_scan(self, name: str, grp: List[AlgoPool],
                            now: float) -> None:
        """Shed queued queries that cannot make their deadline: already
        expired (`drop_expired`), or hopeless — even admitted RIGHT NOW the
        EWMA service-time estimate overshoots the deadline by the policy
        margin."""
        pol = self.slo
        est = self._group_ewma(grp)
        for t, q in self.queues[name].items():
            kept: deque = deque()
            while q:
                req = q.popleft()
                dt = req.deadline_t
                drop = False
                if dt is not None:
                    if pol.drop_expired and now >= dt:
                        drop = True
                    elif (pol.hopeless_margin > 0 and est is not None
                          and now + pol.hopeless_margin * est > dt):
                        drop = True
                if drop:
                    self._drop_request(req)
                else:
                    kept.append(req)
            self.queues[name][t] = kept

    def _pressure(self, name: str, now: float) -> bool:
        """Queue pressure that justifies degraded-pool routing: the
        algorithm's backlog at/above the policy depth, or any queued
        deadline's slack under the policy floor."""
        pol = self.slo
        queued = sum(len(q) for q in self.queues[name].values())
        if queued == 0:
            return False
        if queued >= pol.degrade_queue_depth:
            return True
        slacks = [r.deadline_t - now for q in self.queues[name].values()
                  for r in q if r.deadline_t is not None]
        return bool(slacks) and min(slacks) < pol.degrade_slack_s

    def _maybe_preempt(self, name: str, grp: List[AlgoPool],
                       now: float) -> None:
        """Evict (at most) one long-resident lane per algorithm per pump
        when the group is lane-starved and queued deadline-critical work
        would otherwise miss: the victim's partial state parks in the cache
        and the query re-queues at the FRONT of its tenant queue (it has
        already waited once). Residual-push pools only — their mid-run state
        is resumable. A victim already past its own deadline is dropped
        outright (eviction)."""
        pol = self.slo
        if not pol.preempt:
            return
        if grp[0].program.param("kind") != "residual":
            return
        if any(p.free_lanes() for p in grp):
            return
        slacks = [r.deadline_t - now for q in self.queues[name].values()
                  for r in q if r.deadline_t is not None]
        if not slacks:
            return
        est = self._group_ewma(grp)
        trigger = max(pol.preempt_slack_s,
                      pol.preempt_slack_factor * (est or 0.0))
        if min(slacks) >= trigger:
            return
        victim = None   # (resident_s, pool, lane, rid)
        for p in grp:
            for lane, rid in enumerate(p.lane_rid):
                if rid is None:
                    continue
                resident = now - p.lane_admit_t[lane]
                if resident < pol.preempt_min_resident_s:
                    continue
                if self._preempt_counts.get(rid, 0) >= pol.max_preempts:
                    continue
                if victim is None or resident > victim[0]:
                    victim = (resident, p, lane, rid)
        if victim is None:
            return
        _resident, pool, lane, rid = victim
        saved = pool.preempt(lane)
        source = self._inflight_sources.pop(rid)
        tenant = self._inflight_tenants.pop(rid, "default")
        self._preempt_counts[rid] = self._preempt_counts.get(rid, 0) + 1
        self._count_slo("preempted")
        self._rec("preempt", rid=rid, pool=pool.name, lane=lane,
                  resident_s=round(_resident, 6))
        self.obs.tracer.mark(rid, "preempt")
        dt = self._deadline_t.get(rid)
        req = Request(rid=rid, algo=name, source=source, tenant=tenant,
                      deadline_t=dt, queued_t=time.monotonic())
        if dt is not None and now >= dt and pol.drop_expired:
            self._drop_request(req)
            return
        key = make_key(self.graph_version, name, source,
                       (("partial", rid),))
        self.cache.put(key, CachedEntry(
            saved["planes"][pool.result_field][:-1],
            {"planes": saved["planes"], "it": saved["it"],
             "trace": saved["trace"]},
        ))
        if key in self.cache:   # capacity 0 stores nothing -> fresh restart
            self._preempt_saved[rid] = key
        self.queues[name][tenant].appendleft(req)

    def _harvest_pool(self, name: str, pool: AlgoPool,
                      degraded: bool = False) -> List[Completion]:
        with obs.region("simdx.serve.harvest"):
            out = []
            harvested = pool.harvest()
            mode_rows = None
            if harvested and self.obs.enabled:
                # per-request per-iteration modes come from the existing
                # mode-trace machinery: ONE matrix transfer per harvest that
                # actually yields lanes (never per lane)
                mode_rows = device_fetch(pool.mode_trace())
            now = time.monotonic()
            for lane, rid, result, iters, extras in harvested:
                pool.observe_resident(now - pool.lane_admit_t[lane])
                dt = self._deadline_t.pop(rid, None)
                missed = dt is not None and now > dt
                if missed:
                    self._count_slo("deadline_missed")
                self._rec("harvest", rid=rid, pool=pool.name, lane=lane,
                          iters=iters)
                self._health_complete(rid, now, missed=missed)
                was_preempted = rid in self._preempt_counts
                self._preempt_counts.pop(rid, None)
                self._degraded_rids.discard(rid)
                comp = Completion(
                    rid=rid, algo=name, source=self._source_of(rid, name, result),
                    result=result, iterations=iters, from_cache=False,
                    graph_version=self.graph_version,
                    tenant=self._inflight_tenants.pop(rid, "default"),
                    deadline_missed=missed, degraded=degraded,
                    preempted=was_preempted,
                )
                if not degraded:
                    # degraded answers never cache-fill: the bit-exact key must
                    # keep serving full-tolerance results only
                    self.cache.put(
                        make_key(self.graph_version, comp.algo, comp.source,
                                 pool.cache_params),
                        CachedEntry(comp.result, extras) if extras
                        else comp.result,
                    )
                if self.obs.enabled:
                    self._complete_span(
                        name, pool, lane, rid, iters, mode_rows,
                        slo=self._span_slo(dt, missed=missed, degraded=degraded,
                                           preempted=was_preempted))
                out.append(comp)
            return out

    def _complete_span(self, name: str, pool: AlgoPool, lane: int, rid: int,
                       iters: int, mode_rows,
                       slo: Optional[dict] = None) -> None:
        """Close an engine-served request's span: assemble its per-iteration
        list from the lane's mode-trace row + the pool iteration log's
        per-lane frontier counts / union volumes, observe the lifecycle
        latency histograms. A preempt-resumed lane's pre-preemption
        iterations predate this pool residency's log, so they pad as None
        gaps (`lane_it_base`), keeping mode-trace alignment."""
        tr = self.obs.tracer
        tr.mark(rid, "harvest")
        admit_step = pool.lane_admit_step[lane]
        it0 = pool.lane_it_base[lane]
        counts: List[Optional[int]] = [None] * it0
        unions: List[Optional[int]] = [None] * it0
        for e in pool.iter_log:
            i = e["step"] - admit_step - 1     # iters run THIS residency
            if i < 0:
                continue
            while len(counts) < it0 + i:       # bounded log dropped samples:
                counts.append(None)            # None gaps keep alignment
                unions.append(None)
            counts.append(int(e["counts"][lane]))
            unions.append(int(e["union_fe"]))
        span = tr.complete(rid, from_cache=False, iterations=iters,
                           iters=iters_from_trace(mode_rows[lane], counts,
                                                  unions),
                           graph_version=self.graph_version, slo=slo)
        if span is None:
            return
        d = span.durations()
        reg = self.obs.registry
        lat = default_latency_buckets()
        # cohort leaves aggregate under the ALGORITHM name (capacity split is
        # an implementation detail); the degraded shadow pool keeps its own
        # series — its latencies are not comparable to full-tolerance serving
        hname = pool.name if slo is not None and slo["degraded"] else name
        reg.histogram(f"{hname}.latency_total_s", lat).observe(d["total_s"])
        reg.histogram(f"{hname}.queue_wait_s", lat).observe(d["queue_wait_s"])
        reg.histogram(f"{hname}.resident_s", lat).observe(d["resident_s"])
        reg.histogram(f"{hname}.iterations",
                      default_count_buckets()).observe(iters)
        reg.counter("completions_engine_total").inc()

    def _source_of(self, rid: int, algo: str, result) -> int:
        return self._inflight_sources.pop(rid)

    def drain(self, max_rounds: int = 100000) -> List[Completion]:
        """Pump until the queues and every pool are empty; returns ALL
        completions accumulated so far (cache hits included)."""
        rounds = 0
        while self._queued() or any(p.live() for _n, p, _d in self._leaves()):
            self.pump()
            rounds += 1
            if rounds >= max_rounds:
                # leave a post-mortem timeline before dying: the wedge is
                # exactly what the flight recorder exists for
                self._rec("drain_stuck", rounds=rounds,
                          queued=self._queued())
                if self.obs.flight is not None:
                    path = os.path.join(tempfile.gettempdir(),
                                        "repro_flight_drain_stuck.jsonl")
                    n = self.dump_flight_record(path)
                    raise RuntimeError(
                        f"drain did not converge "
                        f"(flight record: {n} events -> {path})")
                raise RuntimeError("drain did not converge")
        return self.completions

    # -- streaming updates ---------------------------------------------------

    def apply_updates(self, inserts=(), deletes=(), refresh: str = "incremental") -> dict:
        """Absorb one edge-update batch into the served graph (DESIGN.md §8).

        1. Harvest finished lanes under the OLD version (their results are
           valid for it and cache-fill there).
        2. Apply the batch to the StreamingGraph; swap the overlaid views
           into every pool (`AlgoPool.set_graph`).
        3. Selectively invalidate the LRU: entries whose source cannot reach
           a touched endpoint are RE-KEYED to the new version; dirty entries
           are refreshed incrementally from their cached fixpoint when
           `refresh='incremental'` and the program's contract allows
           (`_refresh_cached`), else dropped.
        4. Residual-push pools RESUME their live lanes from corrected
           residuals; the other pools restart their dirtied in-flight lanes
           from scratch on the new graph (clean lanes continue).

        Returns a stats dict (also appended to `self.update_log`); its
        `shipped` holds what each sharded pool's view swap moved to its mesh
        (`ShardedBatchEngine.last_ship`).
        """
        assert self.sg is not None, "GraphServer built without delta_cap"
        assert refresh in ("incremental", "drop")
        # (1) don't let finished old-graph results leak into the new version
        for name, pool, degraded in self._leaves():
            self.completions.extend(
                self._harvest_pool(name, pool, degraded=degraded))

        old_version = self.graph_version
        report = self.sg.apply(inserts, deletes)
        self.graph_version = report.version
        self.g = self.sg.graph
        for _name, pool, _degraded in self._leaves():
            pool.set_graph(self.sg.graph, self.sg.pack, self.sg.delta)
        # parked preempted state is version-bound: the saved residuals are
        # only correctable while resident in a pool, so a version bump
        # invalidates the parked copies and those queries restart
        for rid, key in list(self._preempt_saved.items()):
            self.cache.pop(key)
            del self._preempt_saved[rid]

        # (3) selective cache invalidation / refresh. dirty_src gating is
        # only meaningful for SOURCE-parameterized programs; a source-free
        # program's result depends on the whole graph, so any non-empty
        # batch dirties it.
        changed = (report.n_inserted + report.n_deleted) > 0
        retained = dropped = refreshed = 0
        dirty_entries: Dict[str, list] = {name: [] for name in self.pools}
        for key, value in self.cache.take_version(old_version):
            _v, algo, source, params = key
            source_gated = (algo in self.pools
                            and B._accepts_source(self.pools[algo].program))
            clean = ((not report.dirty_src[source]) if source_gated
                     else not changed)
            if algo in self.pools and clean:
                self.cache.put(
                    make_key(self.graph_version, algo, source, params), value)
                retained += 1
            elif (algo in self.pools
                  and params == self.pools[algo].cache_params):
                # entries matching their pool's cache tag are refresh
                # candidates, re-keyed under the same tag
                dirty_entries[algo].append((source, value))
            else:
                dropped += 1
        if refresh == "incremental":
            refreshed, dropped2 = self._refresh_cached(dirty_entries)
            dropped += dropped2
        else:
            dropped += sum(len(v) for v in dirty_entries.values())
        self.cache.note_invalidated(dropped)

        # (4) dirtied in-flight queries: residual-push pools RESUME every
        # live lane from corrected residuals (clean lanes' corrections are
        # identically zero — they continue bitwise unchanged); everything
        # else restarts its dirty lanes from scratch on the new graph
        re_enqueued_rids = []
        resumed_inflight = 0
        for _name, pool, _degraded in self._leaves():
            if INC.is_residual(pool.program):
                if pool.live():
                    resumed_inflight += pool.resume_residual(self.sg, report)
                continue
            source_gated = B._accepts_source(pool.program)
            for lane, rid in enumerate(pool.lane_rid):
                if rid is None:
                    continue
                source = self._inflight_sources[rid]
                # source-free lanes see the whole graph — any non-empty
                # batch dirties them (mid-run non-monotone state is not a
                # fixpoint, so contract resumes don't apply; restart)
                if report.dirty_src[source] if source_gated else changed:
                    pool.readmit(lane, source)
                    re_enqueued_rids.append(rid)

        stats = {
            "version": self.graph_version,
            "inserted": report.n_inserted,
            "deleted": report.n_deleted,
            "ignored": report.n_ignored,
            "rebuild": report.rebuild,
            "cache_retained": retained,
            "cache_refreshed": refreshed,
            "cache_dropped": dropped,
            "reenqueued_inflight": len(re_enqueued_rids),
            "reenqueued_rids": re_enqueued_rids,
            "resumed_inflight": resumed_inflight,
            # touched-delta slice shipping (DESIGN.md §11): what each
            # sharded pool's view swap moved to its mesh
            "shipped": {
                p.name: dict(p.engine.last_ship)
                for _n, p, _d in self._leaves() if hasattr(p, "engine")
            },
        }
        self.update_log.append(stats)
        self._rec("update_swap", version=self.graph_version,
                  inserted=report.n_inserted, deleted=report.n_deleted,
                  rebuild=report.rebuild,
                  resumed=resumed_inflight, reenqueued=len(re_enqueued_rids))
        return stats

    def _refresh_cached(self, dirty_entries: Dict[str, list],
                        chunk: int = 64) -> tuple:
        """Incrementally recompute dirty cached fixpoints instead of
        dropping them, per program regime:

          * monotone single-field programs (BFS/SSSP/WCC): the cached (n,)
            primary IS the full metadata, so the previous fixpoint is
            reconstructible and resumes bit-identically;
          * residual-push programs (`ppr_delta`, `pagerank_delta`): cached
            entries carry the (estimate, residual) split (`CachedEntry`),
            so the refresh corrects the residuals and RESUMES the fixpoint;
          * declared-contract programs (params incremental='cascade' |
            'reelect'): the cached result plane plus the declared
            `resume_fields` extras rebuild the previous fixpoint, and
            `incremental_batch` resumes it (falling back to full recompute
            when the contract cannot cover the batch);
          * everything else is dropped.

        Entries refresh in chunks of up to `chunk` sources, one
        `incremental_batch` a chunk on the device, its previous planes
        stacked from the cached host columns (`_lane_plane`); each refreshed
        lane's row is copied to the host on its own, so an entry owns its
        memory.
        """
        from repro_torch.streaming import incremental_batch

        refreshed = dropped = 0
        n = self.sg.n
        dev = self.sg.device

        def put(algo, pool, sources, m, result_f, extra_fs):
            cols = {f: _lane_rows(m[f], n) for f in (result_f, *extra_fs)}
            for j, s in enumerate(sources):
                value = (CachedEntry(cols[result_f][j],
                                     {f: cols[f][j] for f in extra_fs})
                         if extra_fs else cols[result_f][j])
                self.cache.put(make_key(self.graph_version, algo, int(s),
                                        pool.cache_params), value)

        for algo, entries in dirty_entries.items():
            if not entries:
                continue
            pool = self.pools[algo]
            program = pool.program
            est_f = program.param("estimate", "rank")
            if INC.is_residual(program) and pool.result_field == est_f:
                res_f = program.param("residual", "resid")
                # only wrapped entries carry the resumable residual plane
                ok = [(s, v) for s, v in entries
                      if isinstance(v, CachedEntry) and res_f in v.extras]
                dropped += len(entries) - len(ok)
                for i in range(0, len(ok), chunk):
                    part = ok[i:i + chunk]
                    sources = np.asarray([s for s, _v in part], np.int64)
                    prev_m = {
                        est_f: _lane_plane([v.result for _s, v in part], 0.0, dev),
                        res_f: _lane_plane([v.extras[res_f] for _s, v in part], 0.0, dev),
                    }
                    m, _info = incremental_batch(program, self.sg, self.cfg,
                                                 sources, prev_m)
                    put(algo, pool, sources, m, est_f, (res_f,))
                    refreshed += len(part)
                continue
            contract = INC.incremental_contract(program)
            if (contract in ("cascade", "reelect")
                    and pool.result_field == program.param("result", program.primary)):
                needed = [f for f in INC.resume_fields(program)
                          if f != pool.result_field]
                ok = [(s, v) for s, v in entries
                      if not needed
                      or (isinstance(v, CachedEntry)
                          and all(f in v.extras for f in needed))]
                dropped += len(entries) - len(ok)

                def _col(v, f):
                    if f == pool.result_field:
                        return v.result if isinstance(v, CachedEntry) else v
                    return v.extras[f]

                fields = sorted({pool.result_field, *needed})
                for i in range(0, len(ok), chunk):
                    part = ok[i:i + chunk]
                    sources = np.asarray([s for s, _v in part], np.int64)
                    prev_m = {f: _lane_plane([_col(v, f) for _s, v in part], 0.0, dev)
                              for f in fields}
                    m, _info = incremental_batch(program, self.sg, self.cfg,
                                                 sources, prev_m)
                    put(algo, pool, sources, m, pool.result_field, tuple(needed))
                    refreshed += len(part)
                continue
            reconstructible = (
                INC.is_monotone(program)
                and set(pool.meta_fields()) == {program.primary}
                and pool.result_field == program.primary
            )
            if not reconstructible:
                dropped += len(entries)
                continue
            ident = program.combiner.identity_value()
            for i in range(0, len(entries), chunk):
                part = entries[i:i + chunk]
                sources = np.asarray([s for s, _v in part], np.int64)
                prev_m = {program.primary: _lane_plane([v for _s, v in part], ident, dev)}
                m, _info = incremental_batch(program, self.sg, self.cfg,
                                             sources, prev_m)
                put(algo, pool, sources, m, program.primary, ())
                refreshed += len(part)
        return refreshed, dropped

    def stats(self) -> dict:
        """The serving stack's ONE stats surface (DESIGN.md §12) — every
        scattered counter unified behind a documented schema:

          completed / queued / rejected / inflight   request-side totals
          queue          {wait_s, admitted}: seconds requests spent queued,
                         from their latest enqueue to admission, summed over
                         the `admitted` admissions from the queues (host
                         floats, kept with telemetry off)
          cache          ResultCache.stats(): size, capacity, hits, misses,
                         hit_rate, evictions, invalidations
          graph_version  version served right now
          graph          {n_nodes, n_edges, streaming} — `streaming` is
                         StreamingGraph.stats() (delta overlay occupancy
                         `delta_fill`, rebuilds) or None for static servers
          updates        count of absorbed update batches
          last_update    the newest `apply_updates` stats dict (also carries
                         per-pool `shipped` = engine.last_ship) or None
          shard_delta    graph.partition.SHARD_DELTA_STATS process counters
                         (full_reslice / short_circuit overlay re-slices)
          pools          per-algo (cohort groups aggregated: slots and
                         engine_queries summed, steps/tele from the leaves,
                         `cohorts` = leaf count): slots, engine_queries,
                         steps, queue depths/quotas/weights, placement kind,
                         and — when telemetry is on — `tele` (cumulative
                         named engine counters, see obs.TELE_FIELDS) +
                         `last_iter` (newest iteration-log sample) +
                         `imbalance` ({shard_edges: per-shard cumulative
                         scan plane, skew: max/mean}, DESIGN.md §14) +
                         `audit` (push/pull decision-audit summary: logged /
                         push / pull / mode_switches / compact_dense
                         counts, the controller thresholds, and the newest
                         record) + `shipped`; degraded shadow pools appear
                         as '<algo>@degraded' entries with a `degraded` flag
          slo            {"enabled": bool, deadline_missed/dropped/degraded/
                         preempted counts (obs.SLO_FIELDS, always live),
                         "policy": SLOPolicy.describe() or None,
                         "cohort_affinity": tenant -> pinned cohort list}
          health         HealthMonitor.snapshot() (DESIGN.md §14): P²
                         latency quantiles {p50/p95/p99_s, n} over the whole
                         stream + windowed {completions, deadline_missed,
                         miss_rate, burn_per_s, goodput, dropped} +
                         queue_depth {last, peak}; {"enabled": False} when
                         the monitor is off
          obs            Observability.snapshot(): metrics registry dump
                         (counters/gauges/histogram p50-p95-p99 summaries)
                         + span recorder totals + health snapshot + flight
                         ring occupancy; {"enabled": False} when off

        Reading it never issues a device transfer: telemetry values come
        from the host-side iteration log the pump already harvested."""
        pools = {}
        for name, grp in self.pool_groups.items():
            p = grp[0]
            d = {
                "slots": sum(q.slots for q in grp),
                "cohorts": len(grp),
                "engine_queries": sum(q.engine_queries for q in grp),
                "steps": max(q.steps for q in grp),
                "queued": sum(len(q) for q in self.queues[name].values()),
                "queue_quota": self.queue_quota[name],
                "weight": self.weights[name],
                "placement": (
                    p.placement.kind if hasattr(p, "placement") else "single"
                ),
                "tenant_queued": {
                    t: len(q) for t, q in self.queues[name].items()
                },
                "tenant_quota": {
                    t: self.tenant_quota[(name, t)] for t in self.tenants
                },
            }
            if hasattr(p, "engine"):
                d["shipped"] = dict(p.engine.last_ship)
            if self.obs.enabled and any(q.iter_log for q in grp):
                # cumulative counters sum across cohort leaves; the sample
                # fields come from the most recently stepped leaf
                logged = [q for q in grp if q.iter_log]
                tele_sum = np.sum(
                    [np.asarray(q.iter_log[-1]["tele"]) for q in logged],
                    axis=0)
                last = max((q.iter_log[-1] for q in logged),
                           key=lambda e: e["step"])
                d["tele"] = tele_dict(tele_sum)
                d["last_iter"] = {
                    "step": last["step"], "gmode": last["gmode"],
                    "union_fe": last["union_fe"],
                    "overflow": last["overflow"], "live": last["live"],
                }
                plane = self._group_plane(grp)
                if plane.size:
                    d["imbalance"] = {
                        "shard_edges": [int(x) for x in plane],
                        "skew": skew_ratio(plane),
                    }
                audits = [a for q in logged for a in q.audit_log]
                if audits:
                    d["audit"] = {
                        "logged": len(audits),
                        "push": sum(a["mode"] == "push" for a in audits),
                        "pull": sum(a["mode"] == "pull" for a in audits),
                        "mode_switches": sum(a["switched"] for a in audits),
                        "compact_dense_fallbacks": sum(
                            a["compact_dense_d"] for a in audits),
                        "alpha_threshold": p._audit_alpha_edges,
                        "edge_cap": int(p.cfg.edge_cap),
                        "last": max(audits, key=lambda a: a["step"]),
                    }
            pools[name] = d
        for name, p in self.degraded_pools.items():
            d = {
                "slots": p.slots,
                "engine_queries": p.engine_queries,
                "steps": p.steps,
                "placement": "single",
                "degraded": True,
            }
            if self.obs.enabled and p.iter_log:
                last = p.iter_log[-1]
                d["tele"] = tele_dict(last["tele"])
            pools[p.name] = d
        return {
            "completed": len(self.completions),
            "queued": self._queued(),
            "rejected": self.rejected,
            "inflight": len(self._inflight_sources),
            "queue": {"wait_s": self._queue_wait[0], "admitted": self._queue_wait[1]},
            "cache": self.cache.stats(),
            "graph_version": self.graph_version,
            "graph": {
                "n_nodes": self.g.n_nodes,
                "n_edges": self.g.n_edges,
                "streaming": self.sg.stats() if self.sg is not None else None,
            },
            "updates": len(self.update_log),
            "last_update": self.update_log[-1] if self.update_log else None,
            "shard_delta": dict(partition.SHARD_DELTA_STATS),
            "pools": pools,
            "slo": {
                "enabled": self.slo is not None,
                **self.slo_counts,
                "policy": (self.slo.describe()
                           if self.slo is not None else None),
                "cohort_affinity": {
                    t: list(v) for t, v in self.cohort_affinity.items()},
            },
            "health": self.obs.health.snapshot(),
            "obs": self.obs.snapshot(),
        }
