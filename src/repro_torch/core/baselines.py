"""Baseline engines the paper compares against (Fig. 5 / Fig. 12).

Port of `repro.core.baselines`:

  * `run_atomic`       — Gunrock-style: Compute writes straight into a
    combine buffer with conflicting scatters (`scatter_reduce_` amin/amax,
    `index_add_`; on the card these are PyTorch's atomic scatters, which
    is the point of the baseline), frontier from a dense scan each
    iteration.
  * `run_filter_ablation` — single-filter ablations of the JIT manager:
    'ballot' forces a pull and the ballot filter every iteration (on the
    card the pull is the `ell_combine` kernel and the filter the
    `frontier_pack` kernel); 'online' forces push-style compaction and
    stops, reporting the overflow, once the frontier exceeds its capacity
    (paper Fig. 12: "online filter alone cannot work for many graphs").
  * `run_batch_filter` — batch-filter style: the full `edge_cap = m` active
    edge buffer every iteration (its memory cost is the point).

Each runs as a host loop, as `core.engine.run` does, with one packed flag
tensor read per iteration; all share the ACC programs.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core import frontier as F
from repro_torch.core.acc import ACCProgram, gather_meta
from repro_torch.core.engine import (
    PULL,
    PUSH,
    EngineConfig,
    _policy,
    _pull_step,
    _push_step,
    expand_frontier,
    init_state,
    make_kernel_pull,
)
from repro_torch.graph.csr import Graph
from repro_torch.graph.packing import EllPack


def _read(*flags: torch.Tensor) -> list:
    """The one host read per iteration: a packed tensor of flags."""
    return [bool(x) for x in obs.host_flags(torch.stack([f.to(torch.int32) for f in flags]))]


def run_filter_ablation(program: ACCProgram, g: Graph, pack: EllPack,
                        cfg: EngineConfig, which: str, **init_kw):
    """Force a single filter: 'online' => always push + online filter,
    'ballot' => always pull + ballot filter (full scan per iteration)."""
    if which not in ("online", "ballot"):
        raise ValueError(which)
    pull_slice_fn = None
    if which == "ballot" and cfg.pull_impl == "kernel":
        pull_slice_fn = make_kernel_pull(program)
    forced = PUSH if which == "online" else PULL
    st = init_state(program, g, cfg, **init_kw)
    st = st._replace(mode=torch.full_like(st.mode, forced))
    done, ovf = _read(st.done, st.overflow)
    while not (done or (which == "online" and ovf)):
        if which == "online":
            st = _push_step(program, g.out, cfg, st)
        else:
            st = _pull_step(program, pack, cfg, st, g.out, pull_slice_fn)
        st = _policy(program, cfg, g.n_edges, st)
        st = st._replace(mode=torch.full_like(st.mode, forced))
        done, ovf = _read(st.done, st.overflow)
    failed = st.overflow if which == "online" else torch.zeros_like(st.overflow)
    stats = {"iterations": st.it, "failed_overflow": failed,
             "final_count": st.count}
    return st.m, stats


def _scatter_combine(name: str, buf: torch.Tensor, dst: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """The atomic-update model: a conflicting scatter into `buf`, seeded
    with the identity (the reference's `.at[dst].min/max/add`)."""
    if name == "sum":
        return buf.index_add_(0, dst, vals)
    return buf.scatter_reduce_(0, dst, vals, reduce="amin" if name == "min" else "amax")


def _frontier_loop(program: ACCProgram, cfg: EngineConfig, st, body):
    """Step `body(st) -> (m_new, ids, count, overflow)` until the frontier
    empties or the iteration budget runs out."""
    max_it = program.fixed_iters if program.fixed_iters is not None else cfg.max_iters
    (done,) = _read(st.done)
    while not done:
        m_new, ids, count, ovf = body(st)
        it = st.it + 1
        st = st._replace(m=m_new, frontier=ids, count=count, overflow=ovf, it=it,
                         done=(count == 0) | (it >= max_it))
        (done,) = _read(st.done)
    return st


def run_atomic(program: ACCProgram, g: Graph, cfg: EngineConfig, **init_kw):
    """Gunrock-style atomic-update engine: scatter-combine straight into a
    vertex buffer (no edge->vertex reduction stage), dense rescan filter."""
    st0 = init_state(program, g, cfg, **init_kw)
    comb = program.combiner
    n = g.n_nodes

    def body(s):
        src, dst, w, valid_e, _ = expand_frontier(g.out, s.frontier, s.count, cfg.edge_cap)
        upd = program.compute(gather_meta(s.m, src.long()), w, gather_meta(s.m, dst.long()))
        upd = torch.where(valid_e, upd, comb.identity_value())
        seg = torch.full((n + 1,), comb.identity_value(), dtype=upd.dtype, device=upd.device)
        seg = _scatter_combine(comb.name, seg, dst.long(), upd)
        m_new = program.run_apply(s.m, seg, s.it)
        changed_v = program.active(m_new, s.m, s.it).clone()
        changed_v[-1] = False
        ids, count, ovf = F.ballot_filter(changed_v, cfg.frontier_cap, n)
        return m_new, ids, count, ovf

    final = _frontier_loop(program, cfg, st0, body)
    return final.m, {"iterations": final.it, "final_count": final.count}


def run_batch_filter(program: ACCProgram, g: Graph, cfg: EngineConfig, **init_kw):
    """Batch-filter engine (paper Fig. 6a): builds the FULL active edge list
    (buffer sized n_edges), then updates and emits an unsorted frontier
    from the edge buffer."""
    big_cfg = EngineConfig(frontier_cap=cfg.frontier_cap, edge_cap=g.n_edges,
                           fusion=cfg.fusion, alpha=cfg.alpha,
                           max_iters=cfg.max_iters, trace_len=cfg.trace_len)
    st0 = init_state(program, g, big_cfg, **init_kw)
    comb = program.combiner
    n = g.n_nodes

    def body(s):
        src, dst, w, valid_e, _ = expand_frontier(g.out, s.frontier, s.count,
                                                  big_cfg.edge_cap)
        upd = program.compute(gather_meta(s.m, src.long()), w, gather_meta(s.m, dst.long()))
        upd = torch.where(valid_e, upd, comb.identity_value())
        seg = comb.segment(upd, dst, n)
        seg = torch.cat([seg, seg.new_full((1,), comb.identity_value())])
        m_new = program.run_apply(s.m, seg, s.it)
        changed_e = program.active(gather_meta(m_new, dst.long()),
                                   gather_meta(s.m, dst.long()), s.it) & valid_e
        # always dedupe: the batch filter has no pull fallback, so the static
        # frontier buffer must never overflow from redundancy
        changed_e = F.dedupe_winners(changed_e, dst, n)
        ids, count, ovf = F.online_filter(changed_e, dst, big_cfg.frontier_cap, n)
        return m_new, ids, count, ovf

    final = _frontier_loop(program, big_cfg, st0, body)
    return final.m, {"iterations": final.it, "final_count": final.count}


__all__ = ["run_filter_ablation", "run_atomic", "run_batch_filter"]
