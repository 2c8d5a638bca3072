"""Incremental recomputation over a streaming delta overlay (DESIGN.md §8,
§10, §15), port of `repro.streaming.incremental`.

Regimes, chosen per program from its declared METADATA (`incremental_contract`
— never from the program's name):

  * **Monotone** programs (min/max combiner, default apply — BFS, SSSP, WCC):
    the previous fixpoint is a valid state to resume from. Insertions can
    only improve values, so the batched engine is re-entered with the OLD
    metadata and a frontier seeded at just the inserted edges' sources;
    deletions first reset the (conservatively swept) affected region to its
    init values and additionally seed the region's clean boundary PLUS the
    program's own init frontier restricted to the region, which re-pushes
    final values inward. Monotone fixpoints are unique, so the result is
    BIT-IDENTICAL to full recomputation on the updated graph.

  * **Residual-push** programs (params kind='residual' — `ppr_delta`,
    `pagerank_delta`): an update is absorbed by correcting residuals along
    the changed adjacency columns (Maiter-style, `residual_correct`) and
    RESUMING the fixpoint from the surviving residuals — no source re-runs;
    clean lanes' corrections are identically zero and they start converged.

  * **Non-monotone with a declared contract** (params incremental=...):
    'cascade' (k-core) resumes deletion-only batches from the previous
    survivor set (`_cascade_seed_state`); insert-containing batches fall
    back to full recompute. 'reelect' (MIS) re-decides only the
    update-reachable region against frozen outside decisions
    (`_reelect_seed_state`). Both are bit-identical to a cold run.

  * **Non-monotone, source-parameterized, no contract** (PPR power
    iteration): a source that cannot reach any touched endpoint
    (`report.dirty_src`) keeps its previous result; only dirty sources
    re-run, batched, from scratch.

  * **Everything else** (source-free, no contract — global PageRank, BP):
    full recompute on the updated graph.

All paths run against the SAME overlaid (graph, pack, delta) views. The
metadata planes stay on the graph's device: `prev_m` may hold numpy arrays
or tensors, and every result is a dict of tensors. `residual_correct` moves
to the host only the changed sources' rank rows and builds and reduces its
correction terms there, in the reference's pinned numpy order, so its
planes are bit-equal to the reference's; the rest of its work is
elementwise on the device.
"""

from __future__ import annotations


import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import frontier as F
from repro_torch.core.acc import ACCProgram
from repro_torch.core.engine import EngineConfig
from repro_torch.obs.recorder import record_global
from repro_torch.serving import batch_engine as B


def is_monotone(program: ACCProgram) -> bool:
    """Safe to resume from a previous fixpoint: idempotent min/max combiner
    with the default (monoid) apply — any valid upper(min)/lower(max) bound
    converges to the unique fixpoint."""
    return program.combiner.idempotent and program.apply is None


def is_residual(program: ACCProgram) -> bool:
    """Residual-push program (params kind='residual', e.g. `ppr_delta`):
    metadata carries an (estimate, residual) split whose invariant holds at
    EVERY iteration, so an edge update is absorbed by correcting residuals
    along the changed adjacency columns and resuming the fixpoint."""
    return program.param("kind") == "residual"


def incremental_contract(program: ACCProgram) -> str:
    """Classify the streaming-refresh regime for `program` from its declared
    metadata: 'residual' | 'monotone' | 'cascade' | 'reelect' | 'selective'
    (source-parameterized query-granular rerun) | 'full' (recompute — the
    always-safe fallback for programs declaring nothing)."""
    if is_residual(program):
        return "residual"
    if is_monotone(program):
        return "monotone"
    declared = program.param("incremental")
    if declared in ("cascade", "reelect"):
        return declared
    return "selective" if B._accepts_source(program) else "full"


def resume_fields(program: ACCProgram) -> tuple:
    """Metadata planes a resume needs beyond the served result field — the
    serving cache stores these alongside results. Residual programs need
    their (estimate, residual) split; contract programs declare theirs via
    params 'resume_fields'."""
    if is_residual(program):
        return (program.param("estimate", "rank"),
                program.param("residual", "resid"))
    if program.param("incremental") is not None:
        return tuple(program.param("resume_fields", ()))
    return ()


def _tensor(plane, dev: torch.device) -> torch.Tensor:
    """A metadata plane (tensor or numpy) as a tensor on `dev`, dtype kept."""
    if isinstance(plane, torch.Tensor):
        return plane.to(dev)
    return torch.from_numpy(np.array(plane)).to(dev)


def residual_correct(program: ACCProgram, sg, prev_m: dict,
                     report) -> dict:
    """Maiter-style residual correction for one applied update batch.

    The settled estimate x = rank/settle (settle = 1−d for `ppr_delta`, 1.0
    for `pagerank_delta`) was accumulated by pushing d·x(u)/deg(u) along
    each of u's out-edges. An update batch replaces column u of the push
    operator M, so the residual field absorbs the difference

        resid += d * (M' - M) x      (nonzero only for changed sources u,
                                      at u's old/new out-neighbors)

    which restores the invariant for the UPDATED graph mid-run, not just at
    a fixpoint. The degree metadata and the thresholded `send` plane are
    recomputed from the new live degrees under the program's 'threshold'
    rule, so the next frontier comes from the FULL corrected residual field
    (a deletion that lowers deg(u) re-activates a surviving residual at u).

    Returns a fresh {field: (n+1, Q) float32 tensor} dict on the graph's
    device; `prev_m` is not modified.

    Accumulation order is PINNED, as in the reference: every term is a
    (target, (Q,) delta) row in a fixed sequence — changed sources
    ascending, each source's old-multiset retractions before its
    new-multiset additions, targets ascending within each — summed per
    target by one `np.add.reduceat` over a stable target sort, on the host.
    Only the changed sources' rank rows leave the device for it; the sums
    are added to the device residual plane at their targets, and `deg` and
    `send` are elementwise, so the planes are bit-equal to the reference's.
    Never an unordered scatter-add here (ACC-A202).
    """
    d = float(program.param("damping"))
    tol = float(program.param("tol"))
    est = program.param("estimate", "rank")
    res = program.param("residual", "resid")
    settle = float(program.param("settle", 1.0 - d))
    threshold = program.param("threshold", "degree")
    n = sg.n
    dev = sg.device
    # planes in `prev_m`'s order; `deg` and `send` are recomputed below
    m = {k: None if k in ("deg", "send") else _tensor(v, dev).to(torch.float32, copy=True)
         for k, v in prev_m.items()}
    rank, resid = m[est], m[res]

    ins_by_src: dict[int, list] = {}
    del_by_src: dict[int, list] = {}
    for (u, v) in report.ins_edges:
        ins_by_src.setdefault(int(u), []).append(int(v))
    for (u, v) in report.del_edges:
        del_by_src.setdefault(int(u), []).append(int(v))

    changed = sorted(set(ins_by_src) | set(del_by_src))
    term_tgt: list = []
    term_val: list = []
    if changed:
        rows = obs.host_copy(rank[torch.tensor(changed, dtype=torch.long, device=dev)])
    for i, u in enumerate(changed):
        # neighbor MULTISETS: parallel edges each carried one push of
        # d·x/deg, so multiplicity weights the terms — the old multiset is
        # the new one minus this batch's applied inserts plus its applied
        # deletes. Counts over the sorted targets u touches (the reference
        # counts over all n with a bincount: the same nonzero entries)
        new_nbrs = sg.live_out_neighbors(u)                  # with repeats
        new_deg = new_nbrs.size
        ins_v = np.asarray(ins_by_src.get(u, ()), np.int64)
        del_v = np.asarray(del_by_src.get(u, ()), np.int64)
        keys = np.unique(np.concatenate([new_nbrs, ins_v, del_v]))
        # integer counts by bincount (the reference's; never np.add.at)
        k = keys.size
        cnt = np.bincount(np.searchsorted(keys, new_nbrs), minlength=k)
        old_cnt = (cnt - np.bincount(np.searchsorted(keys, ins_v), minlength=k)
                   + np.bincount(np.searchsorted(keys, del_v), minlength=k))
        old_deg = int(old_cnt.sum())
        x_u = rows[i] / settle                               # (Q,)
        if old_deg > 0:
            nz = old_cnt != 0
            idx = keys[nz]                                   # unique targets
            w = old_cnt[nz].astype(np.float32)[:, None]
            term_tgt.append(idx)
            term_val.append(-w * (d * x_u[None, :] / old_deg))
        if new_deg > 0:
            nz = cnt != 0
            idx = keys[nz]
            w = cnt[nz].astype(np.float32)[:, None]
            term_tgt.append(idx)
            term_val.append(w * (d * x_u[None, :] / new_deg))
    if term_tgt:
        tgt = np.concatenate(term_tgt)
        val = np.concatenate(term_val, axis=0).astype(np.float32)  # (T, Q)
        order = np.argsort(tgt, kind="stable")
        tgt, val = tgt[order], val[order]
        uniq, starts = np.unique(tgt, return_index=True)
        sums = np.add.reduceat(val, starts, axis=0)
        at = torch.from_numpy(uniq).to(dev)
        resid[at] = resid[at] + torch.from_numpy(sums).to(dev)

    degf = np.maximum(sg.live_out_degrees(), 1).astype(np.float32)
    degf = np.concatenate([degf, np.ones((1,), np.float32)])
    deg = torch.from_numpy(degf).to(dev)[:, None].expand(rank.shape).contiguous()
    m["deg"] = deg
    ta = tol * deg if threshold == "degree" else tol / n
    send = torch.where(resid.abs() > ta, d * resid / deg, 0.0)
    send[-1] = 0.0
    m["send"] = send
    return m


def _finish_seed(program, g, cfg, st: B.BatchState, m: dict,
                 active: torch.Tensor) -> B.BatchState:
    """Common tail of the resume seed-state builders: install metadata and
    frontier, recount, and re-run the consensus controller (done lanes keep
    their recorded mode)."""
    count = active.sum(0, dtype=torch.int32)
    union_fe, overflow = B._union_volume(g.out, cfg, active)
    st = st._replace(m=m, active=active, count=count, union_fe=union_fe,
                     overflow=overflow, done=count == 0)
    gmode = B._consensus_mode(program, cfg, g.n_edges, st)
    return st._replace(gmode=gmode, mode=torch.where(st.done, st.mode, gmode))


def _seed_state(program, sg, cfg, sources, prev_m, report) -> B.BatchState:
    """BatchState resuming Q lanes from `prev_m` with update-batch seeds."""
    g = sg.graph
    n = g.n_nodes
    dev = sg.device
    st = B.init_batch(program, g, cfg, sources, pack=sg.pack, delta=sg.delta)
    q = st.active.shape[1]
    aff = torch.from_numpy(np.concatenate([report.affected_del, [False]])).to(dev)
    # affected rows fall back to their per-lane INIT values (source row
    # included: a reset source re-inits to distance 0 in its own lane)
    m = {k: torch.where(aff[:, None], st.m[k], _tensor(prev_m[k], dev))
         for k in st.m}
    seeds = np.unique(np.concatenate(
        [report.ins_src, report.boundary]).astype(np.int64))
    active = F.mask_from_ids(torch.from_numpy(seeds).to(dev), n, q=q)
    # the program's own init frontier, restricted to the reset region, also
    # re-seeds: reset rows hold init values that must re-propagate exactly
    # as a cold run's would (bfs/sssp: the lane's source; wcc: every reset
    # vertex)
    active = active | (st.active & aff[:, None])
    return _finish_seed(program, g, cfg, st, m, active)


def _sum_by_target(dst: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """(n, Q) int32 sums of the integer rows `vals` (E, Q) at their targets
    `dst` (E,) in [0, n): a stable sort by target, inclusive prefix sums,
    differenced at each target's bounds (exact: a sum is at most E)."""
    sd, order = torch.sort(dst, stable=True)
    cum = torch.cumsum(vals[order], 0, dtype=torch.int32)
    cum = torch.cat([cum.new_zeros((1,) + tuple(cum.shape[1:])), cum])
    bounds = torch.searchsorted(sd, torch.arange(n + 1, dtype=sd.dtype, device=sd.device))
    return cum[bounds[1:]] - cum[bounds[:-1]]


def _cascade_seed_state(program, sg, cfg, sources, prev_m,
                        report) -> B.BatchState:
    """Resume a deletion cascade (params incremental='cascade', k-core) from
    the previous fixpoint's survivor set. Deletion-only batches ONLY.

    Deletions only shrink effective degrees, so every previously-dead vertex
    stays dead and the previous survivors form a valid mid-cascade state of
    a cold run on the updated graph, rebuilt from the previous `alive`
    plane alone:

        deg(x) = live_out_deg'(x) − #{live edges w→x : w previously dead}

    The dead-predecessor counts are integer sums on the device, a stable
    sort by target then prefix sums differenced at each target's bounds
    (`_sum_by_target`: the reference's sort-then-reduce order, never an
    unordered scatter-add). The resume
    frontier is the survivor set the deletions pushed below k; deaths are
    confluent, so the fixpoint is BIT-IDENTICAL to a cold run.
    """
    k = float(program.param("k"))
    g = sg.graph
    n = sg.n
    dev = sg.device
    st = B.init_batch(program, g, cfg, sources, pack=sg.pack, delta=sg.delta)
    q = st.active.shape[1]
    alive_prev = _tensor(prev_m["alive"], dev).to(torch.float32)[:n] > 0   # (n, Q)
    src, dst = sg.live_edges_coo()
    dead_in = _sum_by_target(dst, (~alive_prev[src]).to(torch.int32), n)
    dead_in = dead_in.to(torch.float32)
    del src, dst
    live_out = torch.from_numpy(
        sg.live_out_degrees().astype(np.float32)).to(dev)[:, None]         # (n, 1)
    deg = torch.where(alive_prev, torch.clamp(live_out - dead_in, min=0.0), 0.0)
    dead_now = alive_prev & (deg < k)
    alive = alive_prev & ~dead_now
    deg = torch.where(dead_now, 0.0, deg)

    def plane(body, scratch):
        row = torch.full((1, q), scratch, dtype=torch.float32, device=dev)
        return torch.cat([body.to(torch.float32), row])

    # scratch rows mirror init: alive=1 (sentinel gathers stay inert),
    # dead_now/deg = 0
    m = {"dead_now": plane(dead_now, 0.0), "alive": plane(alive, 1.0),
         "deg": plane(deg, 0.0)}
    active = torch.cat([dead_now, torch.zeros((1, q), dtype=torch.bool, device=dev)])
    return _finish_seed(program, g, cfg, st, m, active)


def _reelect_seed_state(program, sg, cfg, sources, prev_m,
                        report) -> B.BatchState:
    """Re-decide (params incremental='reelect', MIS) only the
    update-reachable region, against frozen outside decisions.

    The region is the forward sweep from every touched endpoint over the
    union graph: a vertex outside it has no in-path from any changed edge,
    so its previous state is what a cold run on the updated graph decides.
    Region rows reset to their INIT planes; outside rows keep their previous
    planes, whose frozen signals the re-election reads through the pulls.
    With unique priorities on symmetric adjacency the greedy MIS is unique,
    so the region's decisions equal a cold run's, bit for bit.
    """
    g = sg.graph
    dev = sg.device
    st = B.init_batch(program, g, cfg, sources, pack=sg.pack, delta=sg.delta)
    region = sg._sweep("forward", np.asarray(report.touched, np.int64))
    # scratch row always from init (True): the sentinel slot must stay at
    # the init identity encoding for padded gathers to stay inert
    reg = torch.from_numpy(np.concatenate([region, [True]])).to(dev)[:, None]
    m = {kf: torch.where(reg, st.m[kf], _tensor(prev_m[kf], dev).to(torch.float32))
         for kf in st.m}
    # frontier = the undecided region (init frontier ∩ region)
    active = st.active & reg
    return _finish_seed(program, g, cfg, st, m, active)


def reseed_from_residuals(program, cfg, g, st: B.BatchState,
                          m: dict) -> B.BatchState:
    """Re-derive a BatchState's frontier/consensus planes from residual
    metadata `m` ({field: (n+1, Q) tensor}). The frontier comes from
    `program.active` over the FULL field, masked by done lanes; the masked
    pull's `hot` plane goes all-hot. Shared by the offline resume
    (`_residual_seed_state`), the serving in-flight resume
    (`scheduler._LanePool.resume_residual`) and `admit_resume`."""
    active = program.active(m, m, st.it).clone()
    active[-1] = False
    active &= ~st.done[None, :]
    count = active.sum(0, dtype=torch.int32)
    union_fe, overflow = B._union_volume(g.out, cfg, active)
    st = st._replace(m=m, active=active, count=count,
                     union_fe=union_fe, overflow=overflow)
    if st.hot is not None:
        st = st._replace(hot=torch.ones_like(st.hot))
    gmode = B._consensus_mode(program, cfg, g.n_edges, st)
    return st._replace(gmode=gmode,
                       mode=torch.where(st.done, st.mode, gmode))


def _residual_seed_state(program, sg, cfg, sources, m0: dict) -> B.BatchState:
    """BatchState resuming Q lanes from corrected residual metadata: the
    frontier is exactly the above-threshold residual set, so converged
    lanes start done and the rest re-enter the loop mid-fixpoint."""
    g = sg.graph
    st = B.init_batch(program, g, cfg, sources, pack=sg.pack, delta=sg.delta)
    st = st._replace(done=torch.zeros_like(st.done))
    st = reseed_from_residuals(program, cfg, g, st, m0)
    return st._replace(done=st.count == 0)


def incremental_batch(
    program: ACCProgram,
    sg,
    cfg: EngineConfig,
    sources,
    prev_m: dict,
    report=None,
    fusion: str = "all",
):
    """Refresh Q previous fixpoints after `sg.apply(...)`.

    `prev_m` is the vertex-major metadata dict {field: (n+1, Q)} (tensors or
    numpy) a previous `run_batch`/`incremental_batch` over the SAME
    `sources` returned (for min programs a {primary: ...} dict rebuilt from
    cached results is enough; contract programs need their declared
    `resume_fields`). Returns (metadata, info): bit-identical to
    `run_batch(program, sg.graph, sg.pack, cfg, sources, delta=sg.delta)`
    for min/max and integer programs, within float tolerance for residual
    sums.

    The regime comes from `incremental_contract(program)`, and every regime
    that cannot honor its contract for THIS batch (a cascade batch
    containing inserts) falls back to full recompute.
    """
    report = report if report is not None else sg.last_report
    assert report is not None, "apply an update batch before recomputing"
    sources_np = np.asarray(sources, dtype=np.int64)
    q = int(sources_np.shape[0])
    contract = incremental_contract(program)

    def _full(reason: str):
        m, stats = B.run_batch(program, sg.graph, sg.pack, cfg, sources_np,
                               fusion=fusion, delta=sg.delta)
        info = {"mode": "full-recompute", "reason": reason, "reran": q,
                "iterations": int(stats["iterations"]),
                "per_query_iters": stats["per_query_iters"]}
        record_global("incremental", mode=info["mode"], reason=reason,
                      reran=q, iterations=info["iterations"])
        return m, info

    def _resume(mode: str, st0: B.BatchState):
        resumed = int((st0.count > 0).sum())
        m, stats = B.run_state(program, sg.graph, sg.pack, cfg, st0,
                               delta=sg.delta, fusion=fusion)
        info = {"mode": mode, "resumed": resumed, "retained": q - resumed,
                "iterations": int(stats["iterations"]),
                "per_query_iters": stats["per_query_iters"]}
        record_global("incremental", mode=mode, resumed=resumed,
                      iterations=info["iterations"])
        return m, info

    if contract == "full":
        return _full("no-incremental-contract")

    if contract == "cascade":
        if report.n_inserted > 0:
            # insertions can resurrect vertices; the cascade contract only
            # covers monotone-downward (deletion) batches
            return _full("cascade-saw-inserts")
        return _resume("cascade-resume", _cascade_seed_state(
            program, sg, cfg, sources_np, prev_m, report))

    if contract == "reelect":
        return _resume("reelect-resume", _reelect_seed_state(
            program, sg, cfg, sources_np, prev_m, report))

    if contract == "residual":
        # residual resume (Maiter-style): the frontier comes from the FULL
        # corrected residual field, not from dirty-source gating or
        # update-endpoint seeds
        m0 = residual_correct(program, sg, prev_m, report)
        return _resume("residual-resume", _residual_seed_state(
            program, sg, cfg, sources_np, m0))

    if contract == "monotone":
        st0 = _seed_state(program, sg, cfg, sources_np, prev_m, report)
        m, stats = B.run_state(program, sg.graph, sg.pack, cfg, st0,
                               delta=sg.delta, fusion=fusion)
        info = {"mode": "monotone-incremental", "reran": q,
                "iterations": int(stats["iterations"]),
                "per_query_iters": stats["per_query_iters"]}
        record_global("incremental", mode=info["mode"], reran=q,
                      iterations=info["iterations"])
        return m, info

    in_range = (sources_np >= 0) & (sources_np < sg.n)
    dirty = np.where(in_range,
                     report.dirty_src[np.clip(sources_np, 0, sg.n - 1)],
                     True)                    # out-of-range: never retain
    dirty_idx = np.nonzero(dirty)[0]
    m = {k: _tensor(v, sg.device) for k, v in prev_m.items()}
    iters = 0
    if dirty_idx.size:
        sub, stats = B.run_batch(
            program, sg.graph, sg.pack, cfg, sources_np[dirty_idx],
            fusion=fusion, delta=sg.delta)
        cols = torch.from_numpy(dirty_idx).to(sg.device)
        m = {k: v.clone().index_copy_(1, cols, sub[k].to(v.dtype)) for k, v in m.items()}
        iters = int(stats["iterations"])
    info = {"mode": "selective-rerun", "reran": int(dirty_idx.size),
            "retained": q - int(dirty_idx.size), "iterations": iters}
    record_global("incremental", mode=info["mode"], reran=info["reran"],
                  retained=info["retained"], iterations=iters)
    return m, info
