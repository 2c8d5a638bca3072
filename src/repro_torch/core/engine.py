"""The SIMD-X processing engine: JIT task management + push-pull steps.

Port of `repro.core.engine` (paper Sec. 4-5):

  * push step  = frontier-driven edge expansion (balanced by a searchsorted
    split of a static `edge_cap` buffer) + Compute + segment Combine (the
    deterministic `segment_reduce` kernel on the card) + online filter.
  * pull step  = a pass over the degree-bucketed ELL slices of the in-CSR +
    Compute + Combine (the `ell_combine` kernel with `pull_impl='kernel'`,
    the default) + ballot filter (the `frontier_pack` kernel).
  * JIT controller = `_policy`: pull on overflow or when the frontier's
    edge volume passes `alpha * |E|` or the edge budget, push otherwise.

Every buffer has a static shape (`frontier_cap`, `edge_cap`), so a later
slice can capture iterations in a CUDA graph. The three fusion modes keep
their names, results and `mode_trace`, but in this port all three are loops
driven by the host: each iteration reads one small packed `(done, mode)`
tensor from the device — the only host sync per iteration — and `mode_trace`
and `fe_trace` stay on the device until the end. `'all'` dispatches push or
pull from one loop, `'pushpull'` runs specialized inner loops per direction,
`'none'` re-decides every step. The device-resident fused loop (the paper's
persistent kernel with its global barrier, or CUDA-graph chunks with a
device-side `done` flag) is future work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import frontier as F
from repro_torch.core.acc import ACCProgram, Meta, gather_meta
from repro_torch.graph.csr import CSR, EdgeDelta, Graph, live_degrees
from repro_torch.graph.packing import EllPack
from repro_torch.kernels import ops as kops

PUSH, PULL = 0, 1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    frontier_cap: int                  # static frontier buffer (paper: thread bins)
    edge_cap: int                      # push-phase edge budget
    fusion: str = "all"                # 'none' | 'all' | 'pushpull'
    alpha: float = 0.15                # push->pull when frontier edges > alpha*|E|
    max_iters: int = 4096
    trace_len: int = 512               # mode trace for the Fig.8-style report
    pull_impl: str = "kernel"          # 'kernel' (CUDA ell_combine) | 'torch'
    sparse_combine: bool = False       # beyond-paper sorted push combine
    #: dedupe online-filter output (vote combiners); False reproduces the
    #: paper's redundant-list behaviour
    dedupe_online: bool = True
    #: read only by the batched serving engine
    masked_pull: bool = False
    masked_pull_frac: float = 0.65
    #: read only by the edge-sharded engine (serving/sharded.py)
    shard_compact: bool = True
    shard_compact_frac: float = 0.25


@dataclasses.dataclass(frozen=True)
class EngineState:
    m: Meta
    frontier: torch.Tensor         # (cap,) int32, sentinel n
    count: torch.Tensor            # () int32
    fe_next: torch.Tensor          # () int32 — frontier out-degree volume
    mode: torch.Tensor             # () int32 PUSH/PULL
    overflow: torch.Tensor         # () bool
    it: torch.Tensor               # () int32
    done: torch.Tensor             # () bool
    push_iters: torch.Tensor
    pull_iters: torch.Tensor
    switches: torch.Tensor
    mode_trace: torch.Tensor       # (trace_len,) int8: 0 push, 1 pull, -1 unused
    fe_trace: torch.Tensor         # (trace_len,) int32 volume entering each iteration

    def _replace(self, **kw) -> "EngineState":
        return dataclasses.replace(self, **kw)


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# frontier expansion (push): merge-path balanced CSR gather
# ---------------------------------------------------------------------------


def _row_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Index `i` into an (n+1,) row pointer as a JAX gather reads it: a
    negative id wraps once, then it is clamped. Only an init's frontier
    can hold an id below -(n+1) (an out-of-range query source); torch would
    raise on it and the card would assert."""
    return torch.where(i < 0, i + (n + 1), i).clamp_(0, n)


def expand_frontier(csr: CSR, ids: torch.Tensor, count: torch.Tensor,
                    edge_cap: int):
    """Expand the frontier's adjacency into a flat (edge_cap,) buffer with
    balanced lanes: lane e binary-searches which frontier vertex owns edge e.
    Returns (src, dst, w, valid, total_edges). Batch-generic: `ids` may be
    (..., cap) with `count` (...,).

    Out-of-range gathers are clamped explicitly (JAX clamps silently, CUDA
    would fault); `_row_index` treats a negative id as JAX does.
    """
    n = csr.n_nodes
    dev = ids.device
    cap = ids.shape[-1]
    rp = csr.row_ptr
    valid_v = torch.arange(cap, dtype=torch.int32, device=dev) < count[..., None]
    safe = torch.where(valid_v, torch.clamp(ids, max=n - 1), 0).long()
    lo = rp[_row_index(safe, n)]
    deg = torch.where(valid_v, rp[_row_index(safe + 1, n)] - lo, 0)
    cum = torch.cumsum(deg, -1, dtype=torch.int32)              # inclusive
    if cap > 0:
        total = cum[..., -1]
    else:
        total = torch.zeros(count.shape, dtype=torch.int32, device=dev)
    e = torch.arange(edge_cap, dtype=torch.int32, device=dev)
    e_b = e.expand(cum.shape[:-1] + (edge_cap,)).contiguous()
    owner = torch.searchsorted(cum.contiguous(), e_b, right=True)
    owner = torch.clamp(owner, max=cap - 1)
    start = torch.gather(cum, -1, owner) - torch.gather(deg, -1, owner)
    within = e - start
    src = torch.gather(safe, -1, owner)
    ptr = torch.clamp(torch.gather(lo, -1, owner) + within, max=csr.n_edges - 1).long()
    valid_e = e < torch.clamp(total, max=edge_cap)[..., None]
    valid_e = valid_e.expand(src.shape)
    dst = torch.where(valid_e, csr.col_idx[ptr], n)
    w = torch.where(valid_e, csr.weights[ptr], 0.0)
    src = torch.where(valid_e, src.to(torch.int32), n)
    return src, dst, w, valid_e, total


# ---------------------------------------------------------------------------
# one push / pull iteration
# ---------------------------------------------------------------------------


def _sparse_combine_apply(program, comb, m, upd, dst, n):
    """Beyond-paper push combine for idempotent default-apply programs: one
    combined value per touched destination scattered into the metadata
    (min/max are order-free, so a reducing scatter gives the run-tail fold
    of the reference's sorted associative scan)."""
    primary = program.primary
    base = m[primary]
    newp = base.scatter_reduce(0, dst.long(), upd,
                               reduce="amin" if comb.name == "min" else "amax")
    newp[-1] = base[-1]                         # keep scratch invariant
    out = dict(m)
    out[primary] = newp
    return out


def _push_step(program: ACCProgram, csr: CSR, cfg: EngineConfig,
               st: EngineState, delta: Optional[EdgeDelta] = None) -> EngineState:
    n = csr.n_nodes
    comb = program.combiner
    src, dst, w, valid_e, _total = expand_frontier(csr, st.frontier, st.count,
                                                   cfg.edge_cap)
    if delta is not None:
        # streaming insertion overlay: COO lanes appended unconditionally
        src = torch.cat([src, delta.src])
        dst = torch.cat([dst, delta.dst])
        w = torch.cat([w, delta.w])
        valid_e = torch.cat([valid_e, delta.src < n])

    sender = gather_meta(st.m, src.long())
    receiver = gather_meta(st.m, dst.long())
    upd = program.compute(sender, w, receiver)
    upd = torch.where(valid_e, upd, comb.identity_value())

    if cfg.sparse_combine and comb.idempotent and program.apply is None:
        m_new = _sparse_combine_apply(program, comb, st.m, upd, dst, n)
    else:
        # segments [0, n) only: sentinel lanes (dst == n) fall out of range
        # and drop, and the scratch slot holds the identity — run_apply
        # restores slot n of every field, so the result is the reference's
        seg = comb.segment(upd, dst, n)
        seg = torch.cat([seg, seg.new_full((1,), comb.identity_value())])
        m_new = program.run_apply(st.m, seg, st.it)

    new_d = gather_meta(m_new, dst.long())
    old_d = gather_meta(st.m, dst.long())
    changed_e = program.active(new_d, old_d, st.it) & valid_e
    if (not comb.idempotent) or cfg.dedupe_online:
        changed_e = F.dedupe_winners(changed_e, dst, n)
    ids, count, ovf = F.online_filter(changed_e, dst, cfg.frontier_cap, n)

    fe_next = _frontier_volume(csr, ids, count)
    return _advance(st, m_new, ids, count, fe_next, ovf, was_mode=PUSH)


def _pull_step(program: ACCProgram, pack: EllPack, cfg: EngineConfig,
               st: EngineState, csr_for_deg: CSR,
               pull_slice_fn: Optional[Callable] = None) -> EngineState:
    n = pack.n_nodes
    comb = program.combiner
    prim = st.m[program.primary]
    seg = torch.full((n + 1,), comb.identity_value(), dtype=prim.dtype,
                     device=prim.device)
    for s in pack.slices:
        if pull_slice_fn is not None:
            partial = pull_slice_fn(s, prim)
        else:
            nbr = s.nbr.long()
            sender = gather_meta(st.m, nbr)                        # (R, W) each
            recv = {k: v[s.row_id.long()][:, None] for k, v in st.m.items()}
            upd = program.compute(sender, s.wgt, recv)
            upd = torch.where(s.nbr == n, comb.identity_value(), upd)
            # tree reduce: association order pinned (bit-equal to the kernel)
            partial = comb.reduce_axis_tree(upd, axis=1)           # (R,)
        seg = comb.pair(seg, comb.segment(partial, s.row_id, n + 1,
                                          sorted_ids=s.rows_ascending))

    m_new = program.run_apply(st.m, seg, st.it)
    changed_v = program.active(m_new, st.m, st.it).clone()
    changed_v[-1] = False
    ids, count, ovf = F.ballot_filter(changed_v, cfg.frontier_cap, n)
    fe_next = _frontier_volume(csr_for_deg, ids, count)
    return _advance(st, m_new, ids, count, fe_next, ovf, was_mode=PULL)


def _frontier_volume(csr: CSR, ids: torch.Tensor, count: torch.Tensor
                     ) -> torch.Tensor:
    """Frontier out-degree volume (int32); batch-generic."""
    n = csr.n_nodes
    valid = torch.arange(ids.shape[-1], dtype=torch.int32, device=ids.device) < count[..., None]
    safe = torch.where(valid, torch.clamp(ids, max=n - 1), 0).long()
    rp = csr.row_ptr
    deg = torch.where(valid, rp[_row_index(safe + 1, n)] - rp[_row_index(safe, n)], 0)
    return torch.sum(deg, -1, dtype=torch.int32)


def _advance(st: EngineState, m_new, ids, count, fe_next, ovf, was_mode: int
             ) -> EngineState:
    slot = torch.clamp(st.it, max=st.mode_trace.shape[0] - 1).long().reshape(1)
    tr = st.mode_trace.scatter(
        0, slot, torch.full((1,), was_mode, dtype=torch.int8, device=slot.device))
    # st.fe_next is the volume that ENTERED the iteration just executed
    fe_tr = st.fe_trace.scatter(0, slot, st.fe_next.reshape(1))
    return EngineState(
        m=m_new,
        frontier=ids,
        count=count,
        fe_next=fe_next,
        mode=st.mode,  # decided in _policy
        overflow=ovf,
        it=st.it + 1,
        done=st.done,
        push_iters=st.push_iters + (1 if was_mode == PUSH else 0),
        pull_iters=st.pull_iters + (1 if was_mode == PULL else 0),
        switches=st.switches,
        mode_trace=tr,
        fe_trace=fe_tr,
    )


def _policy(program: ACCProgram, cfg: EngineConfig, n_edges: int,
            st: EngineState) -> EngineState:
    """JIT controller (paper Fig. 7 + direction-optimizing volume test).
    The alpha threshold truncates to int32 as the reference's
    `jnp.int32(cfg.alpha * n_edges)` does."""
    dev = st.count.device
    if program.modes == "push":
        want = _i32(PUSH, dev)
    elif program.modes == "pull":
        want = _i32(PULL, dev)
    else:
        heavy = (st.overflow
                 | (st.fe_next > int(cfg.alpha * n_edges))
                 | (st.fe_next > cfg.edge_cap))
        want = torch.where(heavy, PULL, PUSH).to(torch.int32)
    switched = (want != st.mode).to(torch.int32)
    max_it = program.fixed_iters if program.fixed_iters is not None else cfg.max_iters
    done = (st.count == 0) | (st.it >= max_it)
    return st._replace(mode=want, switches=st.switches + switched, done=done)


# ---------------------------------------------------------------------------
# run loop
# ---------------------------------------------------------------------------


def init_state(program: ACCProgram, g: Graph, cfg: EngineConfig,
               delta: Optional[EdgeDelta] = None, **init_kw) -> EngineState:
    n = g.n_nodes
    dev = g.device
    # live degrees: on a streaming overlay the degree a normalizing program
    # divides by counts the edges actually traversed
    deg = live_degrees(g.out, delta)
    m0, f0 = program.init(n, deg, **init_kw)
    cap = cfg.frontier_cap
    if program.modes == "push" and not (cap >= n and cfg.edge_cap >= g.n_edges):
        raise ValueError("push-only programs must not overflow "
                         "(set frontier_cap>=n, edge_cap>=m)")
    # contract: init returns valid-first ids padded with sentinel n
    f0 = f0.to(torch.int32)
    total_valid = (f0 < n).sum(dtype=torch.int32)
    k = min(int(f0.shape[0]), cap)
    ids = torch.full((cap,), n, dtype=torch.int32, device=dev)
    ids[:k] = f0[:k]
    st = EngineState(
        m=m0,
        frontier=ids,
        count=torch.clamp(total_valid, max=k),
        fe_next=_i32(0, dev),
        mode=_i32(PUSH, dev),
        overflow=total_valid > k,
        it=_i32(0, dev),
        done=torch.tensor(False, device=dev),
        push_iters=_i32(0, dev),
        pull_iters=_i32(0, dev),
        switches=_i32(0, dev),
        mode_trace=torch.full((cfg.trace_len,), -1, dtype=torch.int8, device=dev),
        fe_trace=torch.full((cfg.trace_len,), -1, dtype=torch.int32, device=dev),
    )
    st = st._replace(fe_next=_frontier_volume(g.out, st.frontier, st.count))
    return _policy(program, cfg, g.n_edges, st)


def make_kernel_pull(program: ACCProgram) -> Callable:
    """Per-slice pull on the CUDA `ell_combine` kernel (the counterpart of
    the reference's `make_pallas_pull`).

    Restriction: Compute may only read the sender's primary field and the
    edge weight — true for the whole catalog; the program names the op that
    stamps the kernel template in `kernel_compute`.
    """
    op = program.kernel_compute
    if op is None:
        raise ValueError(f"program {program.name!r} declares no kernel_compute; "
                         "use pull_impl='torch'")
    comb = program.combiner.name

    def pull_slice_fn(s, vals):
        return kops.ell_combine(s.nbr, s.wgt, vals, op, comb)

    return pull_slice_fn


def _flags(st: EngineState):
    """The one host read per iteration: (done, mode)."""
    done, mode = torch.stack([st.done.to(torch.int32), st.mode]).tolist()
    return bool(done), mode


def run(program: ACCProgram, g: Graph, pack: EllPack, cfg: EngineConfig,
        pull_slice_fn: Optional[Callable] = None, delta=None, **init_kw):
    """Run an ACC program to convergence on the graph's device. Returns
    (metadata, stats dict of device tensors).

    `delta` is a streaming `EdgeDelta` insertion overlay: its COO lanes ride
    along the push edge buffer every push iteration (the pull path reads
    insertions from a delta slice appended to the pack).
    """
    if pull_slice_fn is None:
        if cfg.pull_impl == "kernel":
            pull_slice_fn = make_kernel_pull(program)
        elif cfg.pull_impl != "torch":
            raise ValueError(f"pull_impl {cfg.pull_impl!r}")
    if cfg.fusion not in ("all", "pushpull", "none"):
        raise ValueError(cfg.fusion)
    st = init_state(program, g, cfg, delta=delta, **init_kw)

    def push(s):
        return _policy(program, cfg, g.n_edges,
                       _push_step(program, g.out, cfg, s, delta))

    def pull(s):
        return _policy(program, cfg, g.n_edges,
                       _pull_step(program, pack, cfg, s, g.out, pull_slice_fn))

    done, mode = _flags(st)
    if cfg.fusion == "pushpull":
        # specialized inner loops, one per direction
        while not done:
            while not done and mode == PUSH:
                st = push(st)
                done, mode = _flags(st)
            while not done and mode == PULL:
                st = pull(st)
                done, mode = _flags(st)
    else:
        # 'all': one loop holding both steps; 'none': one step per dispatch
        while not done:
            st = push(st) if mode == PUSH else pull(st)
            done, mode = _flags(st)

    stats = {
        "iterations": st.it,
        "push_iters": st.push_iters,
        "pull_iters": st.pull_iters,
        "switches": st.switches,
        "mode_trace": st.mode_trace,
        "fe_trace": st.fe_trace,
        "final_count": st.count,
    }
    return st.m, stats
