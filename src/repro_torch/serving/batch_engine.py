"""Batched multi-query ACC engine: Q independent point queries, one loop.

Port of `repro.serving.batch_engine`. Q query states are stacked
vertex-major: every metadata field is (n+1, Q) with the query axis last, and
each query's frontier is a column of a dense (n+1, Q) bool mask
(DESIGN.md §7):

  * every graph-indexed gather pulls contiguous Q-vectors, so one index
    stream serves all queries (SpMV becomes SpMM);
  * **union push**: the frontiers of the live queries are OR-ed, compacted
    once (`frontier_pack`) and expanded once; per-edge updates are masked
    per query and combined by one (E, Q) segment reduction (`Combiner.
    segment`, a stable sort then `segment_reduce` with D = Q);
  * **dense pull**: each ELL slice's (R, Q) partials come from the Q-wide
    `ell_combine_batched` kernel where the program names its Compute op
    (`kernel_compute`), else from the reference's torch expression in row
    chunks; a `segment_reduce` merge (D = Q) a slice;
  * **masked pull** (`cfg.masked_pull`): only rows whose gathered senders
    changed are recomputed, the rest served from a per-slice cache; for
    residual programs the exact `hot` staleness plane makes it bit-equal to
    the dense pull;
  * **consensus JIT controller**: one push/pull decision a iteration for
    the whole batch from the union frontier's edge volume;
  * **done-masking**: converged queries keep their metadata frozen.

For min/max programs every lane is bit-equal to a solo `core.engine.run`;
pull-only programs keep the solo iteration structure, and `segment_reduce`
folds each column of a (E, Q) call as it folds the (E,) call, so their
lanes are bit-equal to solo runs as well.

Differences from the reference, where `lax.while_loop` and `lax.cond` kept
everything on the device: `run_state` is a host loop that reads one packed
(any live, gmode) tensor a iteration, the step dispatches push or pull on
that host value, and the masked pull's per-slice `lax.cond` is a host
branch fed by one packed read a pull of every slice's row-buffer overflow
and the cache flag. `HOST_READS` counts these reads by kind. Telemetry
reads nothing back: `tele` stays on the device. A serving pool reads one
packed (done, it, gmode) tensor a step instead (`pool_flags`).

Under a `torch.profiler` a step is two ranges (`obs.region`):
`simdx.batch.combine`, the push or pull up to its shared tail, and
`simdx.batch.apply`, the tail (`_apply_and_refilter` and `_advance`); each
control-flow read is a `simdx.batch.read`.
"""

from __future__ import annotations

import inspect
import math
from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.core.acc import ACCProgram
from repro_torch.core.engine import PULL, PUSH, EngineConfig, expand_frontier
from repro_torch.graph.csr import CSR, EdgeDelta, Graph, live_degrees
from repro_torch.graph.packing import EllPack, EllSlice
from repro_torch.kernels import ops as kops
from repro_torch.obs import (
    TELE_LEN,
    TELE_MASKED_DENSE,
    TELE_MASKED_ROWS,
    TELE_PULL_EDGES,
    TELE_PUSH_EDGES,
)

#: device->host reads of the engine's control flow since import: `loop`
#: (the packed (any live, gmode) of `run_state`), `gmode` (a step called
#: without the host's gmode), `masked` (one a masked pull), `pool` (the
#: packed (done, it, gmode) a serving pool mirrors, `pool_flags`)
HOST_READS = {"loop": 0, "gmode": 0, "masked": 0, "pool": 0}

#: gathered elements a chunk of the dense pull's torch expression
_PULL_CHUNK = 1 << 24


class GraphDims(NamedTuple):
    """Static graph dimensions, standing in for a full :class:`Graph` on the
    CSR-free admission path: `init_batch` then takes the live-degree vector
    `deg` instead of reading the adjacency."""

    n_nodes: int
    n_edges: int


class BatchState(NamedTuple):
    """Q stacked query states, vertex-major, plus one consensus mode."""

    m: dict                        # {field: (n+1, Q)}
    active: torch.Tensor           # (n+1, Q) bool — frontier mask, scratch row False
    count: torch.Tensor            # (Q,) int32 — per-query frontier size
    union_fe: torch.Tensor         # () int32 — union-frontier out-edge volume
    overflow: torch.Tensor         # () bool — union compaction would overflow
    mode: torch.Tensor             # (Q,) int32 — mode each live lane last ran
    it: torch.Tensor               # (Q,) int32
    done: torch.Tensor             # (Q,) bool
    push_iters: torch.Tensor       # (Q,) int32
    pull_iters: torch.Tensor       # (Q,) int32
    switches: torch.Tensor         # (Q,) int32
    mode_trace: torch.Tensor       # (Q, trace_len) int8
    gmode: torch.Tensor            # () int32 consensus PUSH/PULL
    #: masked-pull partial cache: one (R_s, Q) tensor per ELL slice
    pseg: tuple = ()
    #: () bool — next pull must run dense; None when masked pull is off
    pull_dense: Optional[torch.Tensor] = None
    #: (n+1, Q) bool — senders whose primary changed last iteration, for
    #: residual-push programs under masked pull; None otherwise
    hot: Optional[torch.Tensor] = None
    #: (TELE_LEN + n_shards,) cumulative telemetry counters (layout in
    #: repro_torch/obs), int64 where the reference's are int32: a dense
    #: pull scans 337 M slots at RMAT scale 22, so int32 wraps after seven;
    #: None when telemetry is off
    tele: Optional[torch.Tensor] = None


class _Rows(dict):
    """The rows `idx` of each metadata field, gathered when first read: a
    Compute reads one or two fields, and gathering every (E, Q) field would
    cost the memory that the reference's compiler drops. A 1-D `idx` takes
    `index_select`, the faster gather of whole rows."""

    def __init__(self, m: dict, idx: torch.Tensor):
        super().__init__()
        self._m, self._idx = m, idx

    def __missing__(self, key):
        if self._idx.dim() == 1:
            value = self._m[key].index_select(0, self._idx)
        else:
            value = self._m[key][self._idx]
        self[key] = value
        return value


def _full(value, dtype, device) -> torch.Tensor:
    """A 0-d device constant, written by a kernel (no host-to-device copy,
    which would wait for the stream)."""
    return torch.full((), value, dtype=dtype, device=device)


def _tele_add(tele: torch.Tensor, idx: int, value) -> torch.Tensor:
    out = tele.clone()
    out[idx] += value
    return out


def _accepts_source(program: ACCProgram) -> bool:
    """Whether `program.init` takes a per-query `source=` kwarg."""
    params = inspect.signature(program.init).parameters
    return "source" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _union_volume_deg(deg: torch.Tensor, cfg: EngineConfig, mask: torch.Tensor):
    """Out-edge volume of the union frontier and whether its compaction
    would overflow, from a bare (n,) degree vector."""
    union = mask.any(-1)[:-1]
    fe = torch.where(union, deg, 0).sum(dtype=torch.int32)
    ucount = union.sum(dtype=torch.int32)
    return fe, ucount > cfg.frontier_cap


def _union_volume(csr: CSR, cfg: EngineConfig, mask: torch.Tensor):
    return _union_volume_deg(csr.row_ptr[1:] - csr.row_ptr[:-1], cfg, mask)


def _apply_and_refilter(program, cfg, csr, st, seg):
    """Shared tail of a push/pull iteration: apply the combined updates, take
    the dense changed-mask as the next frontier (ballot semantics), and
    re-aggregate volumes."""
    m_new = program.run_apply(st.m, seg, st.it)
    nxt = program.active(m_new, st.m, st.it).clone()
    nxt[-1].fill_(False)                             # scratch row stays inert
    nxt &= ~st.done[None, :]                         # done lanes push nothing
    count = nxt.sum(0, dtype=torch.int32)
    union_fe, overflow = _union_volume(csr, cfg, nxt)
    hot = None
    if st.hot is not None:
        # exact masked-pull staleness: a cached row partial goes stale iff a
        # gathered sender's primary changed this iteration
        p = program.primary
        hot = (m_new[p] != st.m[p]) & ~st.done[None, :]
    return m_new, nxt, count, union_fe, overflow, hot


# ---------------------------------------------------------------------------
# one batched push / pull iteration
# ---------------------------------------------------------------------------


def _push_step(program: ACCProgram, csr: CSR, cfg: EngineConfig, st: BatchState,
               delta: Optional[EdgeDelta] = None) -> BatchState:
    """Union-frontier push: one compaction and one balanced edge expansion
    for the whole batch, per-query masking on the (E, Q) update matrix, one
    segment combine. A streaming `delta`'s COO lanes are appended to the
    edge buffer unconditionally (sentinel lanes stay inert)."""
    with obs.region("simdx.batch.combine"):
        seg, tele = _push_combine(program, csr, cfg, st, delta)
    with obs.region("simdx.batch.apply"):
        m_new, nxt, count, fe, ovf, hot = _apply_and_refilter(program, cfg, csr, st, seg)
        return _advance(st, m_new, nxt, count, fe, ovf, was_mode=PUSH, cfg=cfg, hot=hot,
                        tele=tele)


def _push_combine(program: ACCProgram, csr: CSR, cfg: EngineConfig, st: BatchState,
                  delta: Optional[EdgeDelta]):
    """The union push up to its tail: compaction, expansion, Compute and
    the segment combine. Returns the combined (n+1, Q) plane and the
    telemetry accumulator."""
    n = csr.n_nodes
    comb = program.combiner
    q = st.it.shape[0]
    union = st.active.any(-1)
    uids, ucount, _ovf = kops.frontier_pack(union[:n].contiguous(), cfg.frontier_cap)
    src, dst, w, valid_e, total = expand_frontier(csr, uids, ucount, cfg.edge_cap)
    if delta is not None:
        src = torch.cat([src, delta.src])
        dst = torch.cat([dst, delta.dst])
        w = torch.cat([w, delta.w])
        valid_e = torch.cat([valid_e, delta.src < n])
    src_l = src.long()
    upd = program.compute(_Rows(st.m, src_l), w[:, None], _Rows(st.m, dst.long()))
    ident = comb.identity_value()
    # an edge carries query q's message iff its source is in q's frontier
    eactive = st.active[src_l] & valid_e[:, None]
    upd = torch.where(eactive, upd, ident)
    # segments [0, n): sentinel lanes (dst == n) drop, and the scratch row
    # holds the identity (run_apply restores it), as in the solo push
    seg = comb.segment(upd, dst, n)
    seg = torch.cat([seg, seg.new_full((1, q), ident)])

    tele = st.tele
    if tele is not None:
        scanned = torch.clamp(total, max=cfg.edge_cap)
        if delta is not None:
            scanned = scanned + (delta.src < n).sum(dtype=torch.int32)
        tele = _tele_add(tele, TELE_PUSH_EDGES, scanned)
    return seg, tele


def _partial_rows(program, comb, m, nbr, wgt, row_id, n: int) -> torch.Tensor:
    """(R, Q) row partials of ELL rows (nbr, wgt of shape (R, W)): the
    `ell_combine_batched` kernel for a program that names its Compute op,
    else the reference's expression in row chunks."""
    if program.kernel_compute is not None:
        return kops.ell_combine_batched(nbr, wgt, m[program.primary],
                                        program.kernel_compute, comb.name)
    r, w = nbr.shape
    prim = m[program.primary]
    q = prim.shape[1]
    ident = comb.identity_value()
    out = torch.empty((r, q), dtype=prim.dtype, device=prim.device)
    step = max(1, _PULL_CHUNK // max(w * q, 1))
    for lo in range(0, r, step):
        nb = nbr[lo:lo + step]
        sender = _Rows(m, torch.clamp(nb, max=n).long())         # (c, W, Q)
        recv = _Rows(m, row_id[lo:lo + step].long()[:, None])     # (c, 1, Q)
        upd = program.compute(sender, wgt[lo:lo + step, :, None], recv)
        upd = torch.where((nb == n)[..., None], ident, upd)
        out[lo:lo + step] = comb.reduce_axis_tree(upd, axis=1)
    return out


def _slice_partial_dense(program, comb, m, s: EllSlice, n: int) -> torch.Tensor:
    """One ELL slice's (R, Q) row partials, every row recomputed."""
    return _partial_rows(program, comb, m, s.nbr, s.wgt, s.row_id, n)


def _masked_rows(s: EllSlice, hot_v: torch.Tensor, cfg: EngineConfig):
    """The rows of a slice that gather a hot sender, compacted into a
    `capR`-row buffer: (capR, ids, count, overflow)."""
    r = s.rows
    cap = min(r, max(8, int(math.ceil(r * cfg.masked_pull_frac))))
    hot = hot_v[s.nbr.long()].any(1)                             # (R,)
    ids, cnt, ovf = kops.frontier_pack(hot, cap)
    return cap, ids, cnt, ovf


def _slice_partial_masked(program, comb, m, s: EllSlice, n: int, prev, sel):
    """Frontier-aware masked pull for one slice, sparse branch: recompute
    the compacted hot rows `sel` = (capR, ids, count) and serve the others
    from the cached partials `prev` (the reference's `sparse`)."""
    cap, ids, cnt = sel
    r = s.rows
    safe = torch.clamp(ids, max=r - 1).long()
    p_sel = _partial_rows(program, comb, m, s.nbr[safe], s.wgt[safe], s.row_id[safe], n)
    # invalid lanes land on a dummy row; `ids` are unique by construction
    lane = torch.arange(cap, dtype=torch.int32, device=ids.device)
    tgt = torch.where(lane < cnt, ids, r).long()
    buf = torch.cat([prev, prev.new_zeros((1, prev.shape[1]))])
    buf[tgt] = p_sel
    return buf[:r]


def _pull_step(program: ACCProgram, pack: EllPack, cfg: EngineConfig, st: BatchState,
               csr_for_deg: CSR) -> BatchState:
    """Full-graph pull over the degree-bucketed ELL slices, all queries at
    once: each slice's (R, Q) partials, then a segment merge per slice. A
    streaming delta rides along as one more slice appended to the pack."""
    with obs.region("simdx.batch.combine"):
        seg, pseg_new, tele = _pull_combine(program, pack, cfg, st)
    with obs.region("simdx.batch.apply"):
        m_new, nxt, count, fe, ovf, hot = _apply_and_refilter(program, cfg, csr_for_deg,
                                                              st, seg)
        return _advance(st, m_new, nxt, count, fe, ovf, was_mode=PULL, cfg=cfg,
                        pseg=pseg_new, hot=hot, tele=tele)


def _pull_combine(program: ACCProgram, pack: EllPack, cfg: EngineConfig, st: BatchState):
    """The pull up to its tail: every slice's partials and merge. Returns
    the combined (n+1, Q) plane, the masked pull's new partial caches (None
    without it) and the telemetry accumulator."""
    n = pack.n_nodes
    comb = program.combiner
    prim = st.m[program.primary]
    q = prim.shape[1]
    seg = torch.full((n + 1, q), comb.identity_value(), dtype=prim.dtype,
                     device=prim.device)
    tele = st.tele
    masked = cfg.masked_pull
    if masked:
        # residual programs carry the exact changed-primary mask (st.hot);
        # the others use the union frontier
        hot_v = (st.hot if st.hot is not None else st.active).any(-1)
        sels = [_masked_rows(s, hot_v, cfg) for s in pack.slices]
        with obs.region("simdx.batch.read"):
            flags = obs.host_flags(torch.stack([st.pull_dense] + [x[3] for x in sels]))
        HOST_READS["masked"] += 1
    pseg_new = []
    for si, s in enumerate(pack.slices):
        dense = not masked or flags[0] or flags[1 + si]
        if dense:
            partial, rows = _slice_partial_dense(program, comb, st.m, s, n), s.rows
        else:
            partial = _slice_partial_masked(program, comb, st.m, s, n, st.pseg[si],
                                            sels[si][:3])
            rows = sels[si][2]
        if tele is not None:
            if masked:
                tele = _tele_add(tele, TELE_MASKED_DENSE, int(dense))
                tele = _tele_add(tele, TELE_MASKED_ROWS, rows)
            tele = _tele_add(tele, TELE_PULL_EDGES, rows * s.width)
        pseg_new.append(partial)
        seg = comb.pair(seg, comb.segment(partial, s.row_id, n + 1,
                                          sorted_ids=s.rows_ascending))
    return seg, tuple(pseg_new) if masked else None, tele


def _advance(st, m_new, nxt, count, union_fe, overflow, was_mode: int, cfg=None,
             pseg=None, hot=None, tele=None) -> BatchState:
    live = ~st.done
    dev = live.device
    q = st.it.shape[0]
    lanes = torch.arange(q, device=dev)
    col = torch.clamp(st.it, max=st.mode_trace.shape[-1] - 1).long()
    tr = st.mode_trace.clone()
    tr[lanes, col] = torch.where(live, was_mode, st.mode_trace[lanes, col]).to(torch.int8)
    keep = st.done[None, :]
    m_merged = {k: torch.where(keep, st.m[k], m_new[k]) for k in st.m}
    # a pull leaves fresh partial caches; a push invalidates them
    pull_dense = st.pull_dense
    if cfg is not None and cfg.masked_pull:
        pull_dense = _full(was_mode == PUSH, torch.bool, dev)
    step = live.to(torch.int32)
    return st._replace(
        m=m_merged,
        active=nxt,
        count=torch.where(live, count, 0),
        union_fe=union_fe,
        overflow=overflow,
        it=st.it + step,
        push_iters=st.push_iters + (step if was_mode == PUSH else 0),
        pull_iters=st.pull_iters + (step if was_mode == PULL else 0),
        mode_trace=tr,
        pseg=st.pseg if pseg is None else pseg,
        pull_dense=pull_dense,
        hot=st.hot if hot is None else hot,
        tele=st.tele if tele is None else tele,
    )


# ---------------------------------------------------------------------------
# consensus policy
# ---------------------------------------------------------------------------


def _consensus_mode(program: ACCProgram, cfg: EngineConfig, n_edges: int, st
                    ) -> torch.Tensor:
    """One push/pull decision for the whole batch (paper Fig. 7 and the
    direction-optimizing volume test over the union frontier); the alpha
    threshold truncates to int32 as the reference's does."""
    dev = st.count.device
    if program.modes == "push":
        return _full(PUSH, torch.int32, dev)
    if program.modes == "pull":
        return _full(PULL, torch.int32, dev)
    heavy = (st.overflow
             | (st.union_fe > int(cfg.alpha * n_edges))
             | (st.union_fe > cfg.edge_cap))
    return torch.where(heavy, PULL, PUSH).to(torch.int32)


def _policy(program: ACCProgram, cfg: EngineConfig, n_edges: int, st: BatchState
            ) -> BatchState:
    max_it = program.fixed_iters if program.fixed_iters is not None else cfg.max_iters
    done = st.done | (st.count == 0) | (st.it >= max_it)
    live = ~done
    want = _consensus_mode(program, cfg, n_edges, st)
    switched = live & (want != st.mode)
    return st._replace(
        mode=torch.where(live, want, st.mode),
        switches=st.switches + switched.to(torch.int32),
        done=done,
        gmode=want,
    )


def make_batched_step(program: ACCProgram, g: Graph, pack: EllPack,
                      cfg: EngineConfig, delta: Optional[EdgeDelta] = None):
    """Per-iteration batched step `step(st, gmode=None) -> BatchState`, used
    by `run_state`'s loop and by a host-stepped scheduler. `gmode` is the
    consensus mode as a host int where the caller has read it; without it
    a program of modes='both' reads `st.gmode` (counted in HOST_READS)."""

    def step(st: BatchState, gmode: Optional[int] = None) -> BatchState:
        if program.modes == "push":
            new = _push_step(program, g.out, cfg, st, delta)
        elif program.modes == "pull":
            new = _pull_step(program, pack, cfg, st, g.out)
        else:
            if gmode is None:
                with obs.region("simdx.batch.read"):
                    gmode = int(st.gmode)
                HOST_READS["gmode"] += 1
            if gmode == PULL:
                new = _pull_step(program, pack, cfg, st, g.out)
            else:
                new = _push_step(program, g.out, cfg, st, delta)
        if st.tele is not None and st.tele.shape[0] > TELE_LEN:
            # single-device per-shard plane: mirror this iteration's scan
            # volume into the (only) shard slot
            inc = new.tele - st.tele
            new = new._replace(tele=_tele_add(new.tele, TELE_LEN,
                                              inc[TELE_PUSH_EDGES] + inc[TELE_PULL_EDGES]))
        return _policy(program, cfg, g.n_edges, new)

    return step


# ---------------------------------------------------------------------------
# init / run
# ---------------------------------------------------------------------------


def init_batch(program: ACCProgram, g, cfg: EngineConfig, sources, done=None,
               pack: Optional[EllPack] = None, check_caps: bool = True,
               delta: Optional[EdgeDelta] = None, deg: Optional[torch.Tensor] = None,
               telemetry: bool = False, tele_shards: int = 1) -> BatchState:
    """Stack Q fresh query states (one per source), vertex-major, on the
    graph's device.

    `done` marks lanes to create empty and inactive. `pack` sizes the
    masked pull's partial caches (required with `cfg.masked_pull`).
    `check_caps=False` skips the push-only no-overflow check. `delta` is the
    streaming insertion overlay, read for live degrees; `deg` passes a
    precomputed live-degree vector instead. `telemetry=True` seeds the
    cumulative `tele` counters, with a trailing per-shard plane of
    `tele_shards` slots. `g` may be a :class:`GraphDims` (with `deg`): the
    union volume then comes from `deg` alone.
    """
    csr_free = isinstance(g, GraphDims)
    if csr_free and deg is None:
        raise ValueError("CSR-free init needs a precomputed live-degree vector")
    if isinstance(sources, torch.Tensor):
        sources = obs.host_flags(sources)
    sources = [int(s) for s in sources]
    q = len(sources)
    n = g.n_nodes
    if program.modes == "push" and check_caps and not (
            cfg.frontier_cap >= n and cfg.edge_cap >= g.n_edges):
        # a push-only program has no pull fallback: a truncated union
        # expansion would silently drop updates
        raise ValueError("push-only programs must not overflow "
                         "(set frontier_cap>=n, edge_cap>=m)")
    if deg is None:
        deg = live_degrees(g.out, delta)
    dev = deg.device
    if _accepts_source(program):
        inits = [program.init(n, deg, source=s) for s in sources]
        m = {k: torch.stack([mi[k] for mi, _ in inits], dim=1) for k in inits[0][0]}
        f_q = torch.stack([fi.to(torch.int64) for _, fi in inits])      # (Q, F)
    else:
        # source-free program (global pagerank): one init, every lane alike
        m_1, f_1 = program.init(n, deg)
        m = {k: v[:, None].expand(n + 1, q).contiguous() for k, v in m_1.items()}
        f_q = f_1.to(torch.int64)[None, :].expand(q, f_1.shape[0])
    mask = torch.zeros((n + 1, q), dtype=torch.bool, device=dev)
    lane = torch.arange(q, device=dev)[:, None].expand(f_q.shape)
    # the reference's scatter drops ids outside [-(n+1), n] (an out-of-range
    # source); they land on the scratch row, cleared below
    f_q = torch.where((f_q >= -(n + 1)) & (f_q <= n), f_q, n)
    mask[f_q, lane] = True
    mask[-1] = False
    done = (torch.zeros((q,), dtype=torch.bool, device=dev) if done is None
            else torch.as_tensor(done, dtype=torch.bool).to(dev))
    mask &= ~done[None, :]
    count = mask.sum(0, dtype=torch.int32)
    if csr_free:
        union_fe, overflow = _union_volume_deg(deg, cfg, mask)
    else:
        union_fe, overflow = _union_volume(g.out, cfg, mask)
    if cfg.masked_pull and pack is not None:
        ident = program.combiner.identity_value()
        dt = m[program.primary].dtype
        pseg = tuple(torch.full((s.rows, q), ident, dtype=dt, device=dev) for s in pack.slices)
        pull_dense = _full(True, torch.bool, dev)
        # residual programs track exact staleness; start all-hot (the first
        # pull is dense anyway and refills every cached partial)
        hot = (torch.ones((n + 1, q), dtype=torch.bool, device=dev)
               if program.param("kind") == "residual" else None)
    else:
        pseg, pull_dense, hot = (), None, None
    zeros = torch.zeros((q,), dtype=torch.int32, device=dev)
    st = BatchState(
        m=m, active=mask, count=count, union_fe=union_fe, overflow=overflow,
        mode=torch.full((q,), PUSH, dtype=torch.int32, device=dev),
        it=zeros, done=done | (count == 0), push_iters=zeros, pull_iters=zeros,
        switches=zeros,
        mode_trace=torch.full((q, cfg.trace_len), -1, dtype=torch.int8, device=dev),
        gmode=_full(PUSH, torch.int32, dev),
        pseg=pseg, pull_dense=pull_dense, hot=hot,
        tele=(torch.zeros((TELE_LEN + int(tele_shards),), dtype=torch.int64, device=dev)
              if telemetry else None),
    )
    want = _consensus_mode(program, cfg, g.n_edges, st)
    return st._replace(gmode=want, mode=torch.where(st.done, st.mode, want))


def _loop_flags(st: BatchState) -> tuple[bool, int]:
    """The one host read a iteration of `run_state`: (any lane live, gmode)."""
    with obs.region("simdx.batch.read"):
        live, gmode = obs.host_flags(torch.stack([(~st.done).any().to(torch.int32),
                                                  st.gmode.to(torch.int32)]))
    HOST_READS["loop"] += 1
    return bool(live), gmode


def pool_flags(st: BatchState) -> tuple[list, list, int]:
    """The one host read a serving pool makes of a state: (done per lane,
    iterations per lane, gmode), packed into one transfer."""
    q = st.done.shape[0]
    with obs.region("simdx.batch.read"):
        flat = obs.host_flags(torch.cat([st.done.to(torch.int32), st.it.to(torch.int32),
                                         st.gmode.to(torch.int32).reshape(1)]))
    HOST_READS["pool"] += 1
    return [bool(x) for x in flat[:q]], flat[q:2 * q], flat[-1]


def run_state(program: ACCProgram, g: Graph, pack: EllPack, cfg: EngineConfig,
              st0: BatchState, delta: Optional[EdgeDelta] = None, fusion: str = "all"):
    """Advance an existing :class:`BatchState` to convergence: the
    streaming subsystem enters here with a state seeded from an earlier
    fixpoint; `run_batch` enters with a fresh state. `fusion` is 'all' or
    'none', both host loops in this port with the same results. Returns
    (metadata dict, stats)."""
    if fusion not in ("all", "none"):
        raise ValueError(fusion)
    step = make_batched_step(program, g, pack, cfg, delta)
    st = st0
    live, gmode = _loop_flags(st)
    while live:
        st = step(st, gmode)
        live, gmode = _loop_flags(st)
    stats = {
        "iterations": st.it.max(),
        "per_query_iters": st.it,
        "push_iters": st.push_iters,
        "pull_iters": st.pull_iters,
        "switches": st.switches,
        "final_count": st.count,
        "mode_trace": st.mode_trace,
        "tele": st.tele,
    }
    return st.m, stats


def run_batch(program: ACCProgram, g: Graph, pack: EllPack, cfg: EngineConfig, sources,
              fusion: str = "all", delta: Optional[EdgeDelta] = None,
              telemetry: bool = False):
    """Run Q point queries of `program` (one per entry of `sources`) to
    convergence as one batch. Returns (metadata dict, field -> (n+1, Q),
    stats). `cfg.pull_impl`/`cfg.sparse_combine` do not apply: the device
    picks the pull's kernel. `telemetry=True` carries the cumulative engine
    counters (stats['tele'])."""
    st0 = init_batch(program, g, cfg, sources, pack=pack, delta=delta,
                     telemetry=telemetry)
    return run_state(program, g, pack, cfg, st0, delta=delta, fusion=fusion)


def query_result(m: dict, field: str, lane: int) -> torch.Tensor:
    """Lane `lane`'s (n,) result from vertex-major batched metadata."""
    return m[field][:-1, lane]


def run_sequential(program_factory, g: Graph, pack: EllPack, cfg: EngineConfig,
                   sources, run_fn=None):
    """The same queries one at a time through the solo engine: the
    reference for bit-identity and the no-batching baseline."""
    from repro_torch.core import engine as E

    run_fn = run_fn or E.run
    return [run_fn(program_factory(), g, pack, cfg, source=int(s))[0] for s in sources]
