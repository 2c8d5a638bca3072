"""Sharded multi-device batched serving engine (DESIGN.md §9).

Port of `repro.serving.sharded`. The batched vertex-major engine
(`serving/batch_engine.py`) runs Q point queries on one device; this module
lifts its loop onto a ('data', 'model') mesh along the two scaling axes:

  * **query-sharded** (`placement='replicated'`): the Q axis splits over the
    'data' axis in contiguous blocks and the graph, pack and delta views are
    replicated. Each query shard runs the unmodified batched push/pull step
    on its Q/D lanes; the only cross-shard state is the JIT controller's
    input: the shards' union masks are OR-ed into the exact global union,
    so the one push/pull decision a iteration (and the mode trace) is the
    single-device engine's.
  * **edge-partitioned** (`placement='edge_sharded'`): `graph/partition.py`'s
    1-D edge shards split over the 'model' axis. Each edge shard scans its
    partition a iteration (masked by the union frontier for push-semantics
    programs, unmasked for pull-only ones), segment-combines into an
    (n+1, Q) partial, and the partials merge in the combine monoid's
    all-reduce. Light iterations of push-semantics programs compact the
    shard's scan to the union frontier's edges (`cfg.shard_compact`, a
    `frontier_pack` of the shard's edge mask into `ceil(E_s *
    shard_compact_frac)` lanes), with the dense scan on overflow; both give
    the same contributions per destination. Admission is CSR-free (the
    cached live-degree vector only), and an update ships only the changed
    shard rows or replicated leaves (`set_graph`, `last_ship`).

The mesh is single-controller, as under the reference's `shard_map`: one
process drives every shard (`repro_torch.mesh`). A state is a tuple of one
`BatchState` a query shard, on that shard's device (`state_specs` says how
each field lies across them). A query shard's state is the metadata the
reference replicates over its mesh row; here it is held once, on the row's
first device, and an edge shard on another device reads it with `.to()`.
The collectives are `mesh.reduce_to`/`all_reduce` over per-shard tensors:
sums fold in shard order (deterministic), min/max and the union's OR are
exact.

Exactness (DESIGN.md §7): query-sharded results are bit-equal to the
single-device batched engine for every program; edge-sharded results are
bit-equal for min/max programs, and sums see one more association (the
shard fold) and match to tolerance. A (1, 1) mesh is bit-equal to
`run_batch` for every program.

Host reads. The reference's loops stay on the device; here a pool or a
`run` reads one packed tensor a step for all shards (`flags`): each lane's
done flag and iterations, each query shard's gmode and, for the compacted
edge scan, its heavy flag and each edge shard's compaction overflow (the
compaction runs when the flags are read). `HOST_READS` counts them.

Consensus flavours: `consensus='global'` (default, the OR-ed controller,
shards step in lockstep) and `consensus='local'` (each query shard decides
from its own union and runs to its own fixpoint; results still bit-equal,
mode traces may diverge; `run` only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core.acc import ACCProgram, Combiner
from repro_torch.core import frontier as F
from repro_torch.core.engine import PULL, PUSH, EngineConfig
from repro_torch.graph import partition
from repro_torch.graph.csr import CSR, EdgeDelta, Graph, live_degrees
from repro_torch.graph.packing import EllPack, EllSlice
from repro_torch.mesh import DATA_AXIS, MODEL_AXIS, ServingMesh, make_mesh, reduce_to
from repro_torch.obs import (
    TELE_COMPACT_DENSE,
    TELE_COMPACT_HITS,
    TELE_LEN,
    TELE_PULL_EDGES,
    TELE_PUSH_EDGES,
)
from repro_torch.serving import batch_engine as B

def make_serving_mesh(n_query_shards: int = 1, n_edge_shards: int = 1,
                      devices: Optional[Sequence] = None) -> ServingMesh:
    """('data', 'model') mesh for sharded pools: D * S devices, by default
    the visible CUDA devices in order (raises when there are fewer). A
    device may be listed several times (`["cpu"] * 4` for a CPU mesh,
    `["cuda:0"] * 4` for four shards on one card)."""
    return make_mesh(n_query_shards, n_edge_shards, devices)


# ---------------------------------------------------------------------------
# the state across query shards
# ---------------------------------------------------------------------------


def state_specs(st: B.BatchState) -> B.BatchState:
    """For each field of a BatchState, the axis that holds its lanes (split
    over 'data' in contiguous blocks), or None where the field is
    replicated: the consensus scalars (kept equal by the global
    controller), the masked pull's dense flag and the cumulative telemetry
    (mesh-global)."""
    return B.BatchState(
        m={k: 1 for k in st.m},
        active=1, count=0, union_fe=None, overflow=None,
        mode=0, it=0, done=0, push_iters=0, pull_iters=0, switches=0,
        mode_trace=0, gmode=None,
        pseg=tuple(1 for _ in st.pseg),
        pull_dense=None,
        hot=None if st.hot is None else 1,
        tele=None,
    )


def _map_fields(st: B.BatchState, fn) -> B.BatchState:
    """Apply `fn(value, axis)` to every tensor of `st` (axis from
    `state_specs`), keeping dicts, tuples and Nones."""
    specs = state_specs(st)
    out = {}
    for name in B.BatchState._fields:
        v, ax = getattr(st, name), getattr(specs, name)
        if v is None:
            out[name] = None
        elif isinstance(v, dict):
            out[name] = {k: fn(x, ax[k]) for k, x in v.items()}
        elif isinstance(v, tuple):
            out[name] = tuple(fn(x, a) for x, a in zip(v, ax))
        else:
            out[name] = fn(v, ax)
    return B.BatchState(**out)


def split_state(st: B.BatchState, devices: Sequence[torch.device]) -> tuple:
    """One state a query shard from a global state: lane fields cut into
    len(devices) contiguous blocks, replicated fields copied, each on its
    shard's device. One shard keeps the tensors themselves (moved only if
    the device differs)."""
    d = len(devices)
    if d == 1:
        return (_map_fields(st, lambda x, ax: x.to(devices[0])),)
    q = st.it.shape[0]
    if q % d:
        raise ValueError(f"{q} lanes do not divide over {d} query shards")
    per = q // d

    def take(i, dev):
        def fn(x, ax):
            if ax is None:
                y = x.to(dev)
                return y.clone() if y is x else y
            return x.narrow(ax, i * per, per).to(dev, copy=True).contiguous()
        return fn

    return tuple(_map_fields(st, take(i, dev)) for i, dev in enumerate(devices))


def gather_state(rows: Sequence[B.BatchState]) -> B.BatchState:
    """The global state of per-query-shard states, on shard 0's device:
    lane fields concatenated in shard order, replicated fields from shard
    0. One shard is returned as it is."""
    if len(rows) == 1:
        return rows[0]
    dev = rows[0].done.device
    specs = state_specs(rows[0])
    out = {}
    for name in B.BatchState._fields:
        vals = [getattr(r, name) for r in rows]
        ax = getattr(specs, name)
        if vals[0] is None:
            out[name] = None
        elif ax is None:
            out[name] = vals[0]
        elif isinstance(vals[0], dict):
            out[name] = {k: torch.cat([v[k].to(dev) for v in vals], ax[k])
                         for k in vals[0]}
        elif isinstance(vals[0], tuple):
            out[name] = tuple(torch.cat([v[i].to(dev) for v in vals], a)
                              for i, a in enumerate(ax))
        else:
            out[name] = torch.cat([v.to(dev) for v in vals], ax)
    return B.BatchState(**out)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _monoid_all_reduce(comb: Combiner, parts: Sequence[torch.Tensor],
                       device: Optional[torch.device] = None) -> torch.Tensor:
    """Merge per-shard partials in the combine monoid on `device` (default:
    shard 0's): sum folds in shard order, min/max are exact."""
    if comb.name not in ("sum", "min", "max"):
        raise ValueError(comb.name)
    return reduce_to(parts, comb.name, device)


def _global_union_volume(deg: torch.Tensor, cfg: EngineConfig,
                         masks: Sequence[torch.Tensor]):
    """The single-device controller's (union_fe, overflow) across query
    shards: the shards' union masks OR-ed (a union of unions, not a sum of
    volumes, so overlapping frontiers count once), then the global union's
    out-edge volume, on `deg`'s device."""
    union = reduce_to([m.any(-1) for m in masks], "or", deg.device)
    fe = torch.where(union[:-1], deg, 0).sum(dtype=torch.int32)
    ucount = union[:-1].sum(dtype=torch.int32)
    return fe, ucount > cfg.frontier_cap


def _live_count(rows: Sequence[B.BatchState]) -> torch.Tensor:
    """Live lanes over every query shard, on shard 0's device."""
    dev = rows[0].done.device
    return sum((~r.done).sum().to(dev) for r in rows)


def _normalize_scalars(rows: Sequence[B.BatchState], n_edge_shards: int) -> tuple:
    """Consensus scalars at loop exit for the flavours whose query shards
    carry shard-local values (local consensus, edge shards): the summed
    volume, any overflow and the max mode, on every shard. Each of a mesh
    row's S edge shards holds the row's values, so the sum over the whole
    mesh counts each row S times, as the reference's psum over both axes
    does. Telemetry sums over query shards only."""
    dev = rows[0].done.device
    fe = sum(r.union_fe.to(dev) for r in rows) * n_edge_shards
    ovf = reduce_to([r.overflow for r in rows], "or", dev)
    gmode = reduce_to([r.gmode for r in rows], "max", dev)
    tele = (None if rows[0].tele is None
            else reduce_to([r.tele for r in rows], "sum", dev))
    out = []
    for r in rows:
        d = r.done.device
        r = r._replace(union_fe=fe.to(d), overflow=ovf.to(d), gmode=gmode.to(d))
        if tele is not None:
            r = r._replace(tele=tele.to(d))
        out.append(r)
    return tuple(out)


# ---------------------------------------------------------------------------
# per-shard step bodies
# ---------------------------------------------------------------------------


def _row_degrees(g: Graph) -> torch.Tensor:
    return g.out.row_ptr[1:] - g.out.row_ptr[:-1]


def _make_replicated_step(program: ACCProgram, cfg: EngineConfig, n_edges: int,
                          consensus: str):
    """One iteration of every query shard: the unmodified single-device
    batched step on each shard's lanes, with the controller inputs
    globalized (the OR-ed union) under `consensus='global'`.

    `step(rows, views, gmodes)`: `views[d]` = (graph, pack, delta) on shard
    d's device, `gmodes[d]` its consensus mode as a host int."""

    def step(rows, views, gmodes) -> tuple:
        new = []
        for st, (g, pack, delta), gm in zip(rows, views, gmodes):
            if program.modes == "push" or (program.modes == "both" and gm != PULL):
                new.append(B._push_step(program, g.out, cfg, st, delta))
            else:
                new.append(B._pull_step(program, pack, cfg, st, g.out))
        if consensus == "global":
            fe, ovf = _global_union_volume(_row_degrees(views[0][0]), cfg,
                                           [s.active for s in new])
            if rows[0].tele is not None:
                # each shard's increment, its scan volume in its own plane
                # slot, summed into the mesh-global accumulator
                incs = []
                for d, (st, s) in enumerate(zip(rows, new)):
                    inc = s.tele - st.tele
                    if inc.shape[0] > TELE_LEN:
                        inc = B._tele_add(inc, TELE_LEN + d,
                                          inc[TELE_PUSH_EDGES] + inc[TELE_PULL_EDGES])
                    incs.append(inc)
                tele = rows[0].tele + reduce_to(incs, "sum")
            new = [s._replace(union_fe=fe.to(s.done.device),
                              overflow=ovf.to(s.done.device),
                              tele=(s.tele if s.tele is None
                                    else tele.to(s.done.device)))
                   for s in new]
        return tuple(B._policy(program, cfg, n_edges, s) for s in new)

    return step


@dataclasses.dataclass
class _ShardView:
    """One edge shard's scan arrays on one device: the shard's base edges
    followed by its overlay lanes, stably sorted by destination (the order
    `Combiner.segment`'s stable sort would give every step), and the mask of
    real edges."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class _ScanPlan:
    """The compacted edge scan's decision for one query shard, made when
    the flags are read: `heavy` (the consensus controller's PULL), and per
    edge shard the union frontier's edge mask with its overflow flag (more
    live edges than the compacted buffer holds). A light step compacts the
    mask (`select_edges`); a heavy one scans densely and never does."""

    heavy: bool
    masks: list          # per edge shard: (E,) bool device tensor
    overflow: list       # per edge shard: bool


def _compact_cap(e_tot: int, cfg: EngineConfig) -> int:
    return min(e_tot, max(128, int(math.ceil(e_tot * cfg.shard_compact_frac))))


def _make_edge_sharded_step(program: ACCProgram, cfg: EngineConfig, n: int,
                            n_edges: int):
    """One iteration of one query shard over its edge shards: scan each
    shard's COO partition (masked by the union frontier for push-semantics
    programs, unmasked for pull-only ones), segment-combine locally, merge
    across edge shards in the combine monoid.

    No edge budget and no truncation. Light iterations of push-semantics
    programs (`cfg.shard_compact`, the controller's PUSH) scan only the
    compacted union-frontier edges of `plan`; a shard whose compaction
    overflowed scans densely. Both give the same contributions per
    destination in the same order, so the results are those of the dense
    scan bit for bit.

    `step(st, shards, deg, plan)` returns (new state, telemetry increment
    as a host list or None, with the per-shard plane)."""
    comb = program.combiner
    masked = program.modes != "pull"
    was_mode = PUSH if masked else PULL
    max_it = program.fixed_iters if program.fixed_iters is not None else cfg.max_iters

    def scan(st, v: _ShardView, sel):
        dev = v.src.device
        m = {k: x.to(dev) for k, x in st.m.items()}
        if sel is None:
            src, dst, w, ok = v.src, v.dst, v.w, v.valid
        else:
            # a compacted buffer's unused lanes repeat the shard's last edge:
            # their destination becomes the sentinel, so they drop out of
            # the segment reduction instead of forming one long segment
            ids, ok = sel
            src, w = v.src[ids], v.w[ids]
            dst = torch.where(ok, v.dst[ids], n)
        upd = program.compute(B._Rows(m, src), w[:, None], B._Rows(m, dst))
        if masked:
            eactive = st.active.to(dev).index_select(0, src) & ok[:, None]
        else:
            eactive = ok[:, None]
        ident = comb.identity_value()
        upd = torch.where(eactive, upd, ident)
        # the shard's arrays are sorted by destination, and a compacted
        # subset keeps that order; segments [0, n): the sentinel lanes (the
        # padding, and a compacted buffer's unused lanes) drop, and the
        # scratch row, which `run_apply` restores, holds the identity
        seg = comb.segment(upd, dst, n, sorted_ids=True)
        return torch.cat([seg, seg.new_full((1, seg.shape[1]), ident)])

    def step(st: B.BatchState, shards: Sequence[_ShardView], deg: torch.Tensor,
             plan: Optional[_ScanPlan]):
        tele_inc = None if st.tele is None else [0] * st.tele.shape[0]
        parts = []
        for s, v in enumerate(shards):
            e_tot = v.src.shape[0]
            if masked and cfg.shard_compact:
                light = not (plan.heavy or plan.overflow[s])
                sel = None
                if light:
                    ids, ok, _ovf = F.select_edges(plan.masks[s], _compact_cap(e_tot, cfg))
                    sel = (ids, ok)
                parts.append(scan(st, v, sel))
                if tele_inc is not None:
                    scanned = _compact_cap(e_tot, cfg) if light else e_tot
                    tele_inc[TELE_COMPACT_HITS] += int(light)
                    tele_inc[TELE_COMPACT_DENSE] += int(not plan.heavy and plan.overflow[s])
                    tele_inc[TELE_PUSH_EDGES] += scanned
            else:
                parts.append(scan(st, v, None))
                scanned = e_tot
                if tele_inc is not None:
                    tele_inc[TELE_PUSH_EDGES if masked else TELE_PULL_EDGES] += e_tot
            if tele_inc is not None and len(tele_inc) > TELE_LEN:
                tele_inc[TELE_LEN + s] += scanned
        seg = _monoid_all_reduce(comb, parts, st.done.device)

        m_new = program.run_apply(st.m, seg, st.it)
        nxt = program.active(m_new, st.m, st.it).clone()
        nxt[-1].fill_(False)
        nxt &= ~st.done[None, :]
        count = nxt.sum(0, dtype=torch.int32)
        fe, ovf = B._union_volume_deg(deg, cfg, nxt)
        new = B._advance(st, m_new, nxt, count, fe, ovf, was_mode=was_mode, cfg=cfg)
        done = new.done | (new.count == 0) | (new.it >= max_it)
        return new._replace(done=done), tele_inc

    return step


def _add_host_tele(tele: torch.Tensor, inc: list) -> torch.Tensor:
    out = tele
    for i, v in enumerate(inc):
        if v:
            out = B._tele_add(out, i, v)
    return out


# ---------------------------------------------------------------------------
# replicated views: leaves of a Graph / EllPack / EdgeDelta
# ---------------------------------------------------------------------------


def _flatten(tree) -> tuple:
    """(leaves, structure) of a graph view, leaf order as the reference's
    pytrees: a Graph's out then inc CSR (four arrays each), a pack's slices
    (nbr, wgt, row_id each), a delta's (src, dst, w)."""
    if isinstance(tree, Graph):
        leaves = [getattr(c, f) for c in (tree.out, tree.inc)
                  for f in ("row_ptr", "col_idx", "weights", "src_idx")]
        return leaves, ("graph", tree.out is tree.inc)
    if isinstance(tree, EllPack):
        leaves = [x for s in tree.slices for x in (s.nbr, s.wgt, s.row_id)]
        return leaves, ("pack", tree.n_nodes,
                        tuple(s.rows_ascending for s in tree.slices))
    if isinstance(tree, EdgeDelta):
        return [tree.src, tree.dst, tree.w], ("delta",)
    raise TypeError(type(tree))


def _unflatten(struct: tuple, leaves: list):
    if struct[0] == "graph":
        out = CSR(*leaves[:4])
        return Graph(out=out, inc=out if struct[1] else CSR(*leaves[4:]))
    if struct[0] == "pack":
        return EllPack(slices=tuple(
            EllSlice(*leaves[3 * i:3 * i + 3], rows_ascending=asc)
            for i, asc in enumerate(struct[2])), n_nodes=struct[1])
    return EdgeDelta(*leaves)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ShardedBatchEngine:
    """The batched ACC loop on a ('data', 'model') mesh.

    `placement='replicated'` splits Q over 'data' with the graph replicated;
    `placement='edge_sharded'` splits the edge list over 'model' (queries
    still split over 'data' when it is > 1). `set_graph` swaps streaming
    views in, shipping only what changed."""

    def __init__(self, program: ACCProgram, g: Graph, pack: EllPack,
                 cfg: EngineConfig, mesh: ServingMesh, *, placement: str = "replicated",
                 consensus: str = "global", delta: Optional[EdgeDelta] = None,
                 telemetry: bool = False):
        assert placement in ("replicated", "edge_sharded"), placement
        assert consensus in ("global", "local"), consensus
        if placement == "edge_sharded":
            assert not cfg.masked_pull, (
                "masked pull's per-slice caches assume a replicated pack")
        assert not (telemetry and consensus == "local"), (
            "telemetry counters are mesh-global (summed increments) — "
            "consensus='local' promises no collectives; run telemetry with "
            "consensus='global'")
        self.telemetry = bool(telemetry)
        self.program = program
        self.cfg = cfg
        self.mesh = mesh
        self.placement = placement
        self.consensus = consensus
        self.n = g.n_nodes
        self.n_edges = g.n_edges
        self.n_query_shards = int(mesh.shape[DATA_AXIS])
        self.n_edge_shards = int(mesh.shape[MODEL_AXIS])
        #: each query shard's device: its state and replicated views live
        #: there (the first device of its mesh row)
        self.row_devices = [mesh.device(d, 0) for d in range(self.n_query_shards)]
        self._rep_cache: dict = {}     # replicated: name -> (struct, leaves, {dev: placed})
        self._row_cache: dict = {}     # edge-sharded: name -> (S, L) device tensor
        self._base_leaves = None
        self._delta_leaves = None
        self._base_shards = None       # EdgeShards of the current base graph
        self._delta_rows = None        # (src, dst, w) (S, L) of the current overlay
        self._views: list = [None] * self.n_edge_shards   # per edge shard: {dev: _ShardView}
        self.deg = None
        self._deg_base = None
        self.delta = delta
        self.last_ship: dict = {}
        self.set_graph(g, pack, delta)

    # -- device views --------------------------------------------------------

    def set_graph(self, g: Graph, pack: EllPack, delta: Optional[EdgeDelta]) -> None:
        """(Re)place the graph views on the mesh, shipping only what changed.

          * replicated placement compares the new views with the previous
            ones leaf by leaf (the streaming overlay keeps untouched tensors
            identity-stable) and ships only the changed leaves to the query
            shards' devices; a leaf already on a device is not copied;
          * edge-sharded placement re-slices the base edges and the overlay
            and ships only the shard rows whose contents changed (one packed
            comparison on the device); each changed shard's scan arrays are
            re-sorted by destination. The adjacency itself never reaches
            the shards: admission reads only the live-degree vector.

        `last_ship` records what this call moved."""
        assert (delta is None) == (self.delta is None), (
            "set_graph cannot change whether a delta overlay exists — "
            "construct the engine with the (possibly empty) delta")
        self.n_edges = g.n_edges
        self.last_ship = {"replicated_leaves_shipped": 0,
                          "replicated_leaves_total": 0,
                          "edge_shards_shipped": 0,
                          "delta_shards_shipped": 0,
                          "n_edge_shards": self.n_edge_shards}
        if self.placement == "replicated":
            gs = self._put_rep_diff("g", g)
            packs = self._put_rep_diff("pack", pack)
            deltas = ([None] * self.n_query_shards if delta is None
                      else self._put_rep_diff("delta", delta))
            #: (graph, pack, delta) on each query shard's device
            self.row_views = list(zip(gs, packs, deltas))
            self.g, self.pack, self.delta = self.row_views[0]
            return
        self.g, self.pack, self.delta = g, pack, delta
        base_leaves = (g.out.row_ptr, g.out.col_idx, g.out.weights, g.out.src_idx)
        base_changed = (self._base_leaves is None or any(
            a is not b for a, b in zip(base_leaves, self._base_leaves)))
        dirty = set()
        if base_changed:
            sh = partition.shard_edges(g, self.n_edge_shards)
            rows = self._place_rows(("esrc", "edst", "ewgt"), (sh.src, sh.dst, sh.wgt))
            self.last_ship["edge_shards_shipped"] = len(rows)
            dirty |= rows
            self._base_shards = sh
            self._base_leaves = base_leaves
        delta_leaves = None if delta is None else (delta.src, delta.dst, delta.w)
        delta_changed = delta is not None and (
            self._delta_leaves is None or any(
                a is not b for a, b in zip(delta_leaves, self._delta_leaves)))
        if delta_changed:
            if self.n_edge_shards == 1:
                # one shard: the round-robin layout is the identity, so take
                # shard_delta's reshape instead of diffing a re-slice
                dsh = partition.shard_delta(delta, 1, self.n)
                self._delta_rows = (dsh.src, dsh.dst, dsh.w)
                self.last_ship["delta_shards_shipped"] = 1
                dirty.add(0)
            else:
                dsh = partition.shard_delta(delta, self.n_edge_shards, self.n)
                rows = self._place_rows(("dsrc", "ddst", "dwgt"), (dsh.src, dsh.dst, dsh.w))
                self._delta_rows = (dsh.src, dsh.dst, dsh.w)
                self.last_ship["delta_shards_shipped"] = len(rows)
                dirty |= rows
            self._delta_leaves = delta_leaves
        for s in sorted(dirty):
            self._build_shard_view(s)
        if base_changed or self._deg_base is None:
            self._deg_base = live_degrees(g.out, None)
        if base_changed or delta_changed or self.deg is None:
            deg = self._deg_base
            if delta is not None:
                # base count plus the overlay's lanes: an insert-only update
                # never recounts the m base edges
                deg = torch.cat([deg, deg.new_zeros(1)])
                deg.index_add_(0, torch.clamp(delta.src.long(), max=self.n),
                               (delta.src < self.n).to(torch.int32))
                deg = deg[:self.n]
            self.deg = deg.to(self.row_devices[0])

    def _put_rep_diff(self, name: str, tree) -> list:
        """`tree` placed on every query shard's device, reusing the resident
        copy of each leaf that is the same tensor object as last time (the
        streaming overlay keeps untouched tensors identity-stable); a
        structure change (an overflow rebuild re-buckets the pack) places
        everything again. A changed leaf counts once in `last_ship`,
        however many devices it goes to; a leaf already on a device is not
        copied. Returns the placed view of each query shard."""
        leaves, struct = _flatten(tree)
        prev = self._rep_cache.get(name)
        same = prev is not None and prev[0] == struct
        changed = ([nl is not ol for nl, ol in zip(leaves, prev[1])] if same
                   else [True] * len(leaves))
        self.last_ship["replicated_leaves_total"] += len(leaves)
        self.last_ship["replicated_leaves_shipped"] += sum(changed)
        placed = {}
        for dev in dict.fromkeys(self.row_devices):
            old = prev[2][dev] if same else [None] * len(leaves)
            memo: dict = {}
            placed[dev] = [memo.setdefault(id(x), x.to(dev)) if c else o
                           for x, c, o in zip(leaves, changed, old)]
        self._rep_cache[name] = (struct, leaves, placed)
        return [_unflatten(struct, placed[dev]) for dev in self.row_devices]

    def _place_rows(self, names: tuple, new: tuple) -> set:
        """Compare (S, L) shard arrays with the previous ones row by row (one
        packed read for every array) and return the rows that changed; a
        shape change changes every row."""
        s = new[0].shape[0]
        prev = [self._row_cache.get(k) for k in names]
        for k, t in zip(names, new):
            self._row_cache[k] = t
        if any(p is None or p.shape != t.shape for p, t in zip(prev, new)):
            return set(range(s))
        diff = torch.stack([(t != p).any(1) for t, p in zip(new, prev)]).any(0)
        return {r for r, c in enumerate(obs.host_flags(diff)) if c}

    def _build_shard_view(self, s: int) -> None:
        """Shard s's scan arrays: its base edges then its overlay lanes,
        stably sorted by destination, on each device of the shard's mesh
        column."""
        sh = self._base_shards
        src, dst, w = sh.src[s], sh.dst[s], sh.wgt[s]
        if self._delta_rows is not None:
            ds, dd, dw = (x[s] for x in self._delta_rows)
            src, dst, w = torch.cat([src, ds]), torch.cat([dst, dd]), torch.cat([w, dw])
        dst, order = torch.sort(dst, stable=True)
        src, w = src[order], w[order]
        valid = (src < self.n) & (dst < self.n)
        views = {}
        for dev in dict.fromkeys(self.mesh.column(s)):
            views[dev] = _ShardView(src.to(dev), dst.to(dev), w.to(dev), valid.to(dev))
        self._views[s] = views

    def shard_views(self, d: int) -> list:
        """Query shard d's edge shards: shard s's scan arrays on device (d, s)."""
        return [self._views[s][self.mesh.device(d, s)] for s in range(self.n_edge_shards)]

    # -- state ---------------------------------------------------------------

    def init(self, sources, done=None) -> tuple:
        """Initial state for Q = len(sources) lanes (Q must divide by the
        'data' axis): one BatchState a query shard. `init_batch` computes
        the global consensus inputs before the lanes are split, so iteration
        0's decision is the single-device one. Edge-sharded engines init
        CSR-free: the graph's dims and the live-degree vector only."""
        if isinstance(sources, torch.Tensor):
            sources = obs.host_flags(sources)
        sources = [int(s) for s in sources]
        assert len(sources) % self.n_query_shards == 0, (
            len(sources), self.n_query_shards)
        if self.placement == "edge_sharded":
            st = B.init_batch(self.program, B.GraphDims(self.n, self.n_edges), self.cfg,
                              sources, done=done, check_caps=False, deg=self.deg,
                              telemetry=self.telemetry, tele_shards=self.n_edge_shards)
        else:
            pack = self.pack if self.cfg.masked_pull else None
            st = B.init_batch(self.program, self.g, self.cfg, sources, done=done,
                              pack=pack, delta=self.delta, telemetry=self.telemetry,
                              tele_shards=self.n_query_shards)
        return self.split(st)

    def split(self, st: B.BatchState) -> tuple:
        return split_state(st, self.row_devices)

    def gather(self, rows: Sequence[B.BatchState]) -> B.BatchState:
        return gather_state(rows)

    def sync_consensus(self, rows: Sequence[B.BatchState], csr_free: bool) -> tuple:
        """After an admission: the global union volume and consensus mode,
        set on every query shard. The volume counts the live degrees on the
        CSR-free path, else the CSR's row lengths (slots), as the
        single-device admission does."""
        deg = (self.deg if csr_free else _row_degrees(self.g)).to(self.row_devices[0])
        fe, ovf = _global_union_volume(deg, self.cfg, [r.active for r in rows])
        st0 = rows[0]._replace(union_fe=fe, overflow=ovf)
        gmode = B._consensus_mode(self.program, self.cfg, self.n_edges, st0)
        return tuple(r._replace(union_fe=fe.to(r.done.device),
                                overflow=ovf.to(r.done.device),
                                gmode=gmode.to(r.done.device)) for r in rows)

    # -- the one host read a step --------------------------------------------

    def _plan(self, rows) -> tuple:
        """Per query shard, the device flags of the compacted edge scan
        (heavy, and each edge shard's compaction overflow) and the edge
        masks; empty unless this engine compacts."""
        if not (self.placement == "edge_sharded" and self.program.modes != "pull"
                and self.cfg.shard_compact):
            return [], []
        flags, masks = [], []
        for d, st in enumerate(rows):
            heavy = B._consensus_mode(self.program, self.cfg, self.n_edges, st) == PULL
            row_masks, ovfs = [], []
            for v in self.shard_views(d):
                dev = v.src.device
                union = st.active.to(dev).any(-1)
                eact = union.index_select(0, v.src) & v.valid
                ovf = eact.sum() > _compact_cap(v.src.shape[0], self.cfg)
                row_masks.append(eact)
                ovfs.append(ovf.to(rows[0].done.device))
            flags.append(torch.stack([heavy.to(rows[0].done.device)] + ovfs))
            masks.append(row_masks)
        return flags, masks

    def flags(self, rows: Sequence[B.BatchState]):
        """The one packed host read of a state, for every shard: (done per
        lane, iterations per lane, gmode per query shard, scan plans). The
        compacted edge scan's masks and overflow flags are read here."""
        dev = rows[0].done.device
        q = sum(r.done.shape[0] for r in rows)
        plan_flags, plan_masks = self._plan(rows)
        parts = ([r.done.to(torch.int32).to(dev) for r in rows]
                 + [r.it.to(torch.int32).to(dev) for r in rows]
                 + [torch.stack([r.gmode.to(torch.int32).to(dev) for r in rows])]
                 + [f.to(torch.int32) for f in plan_flags])
        flat = obs.host_flags(torch.cat(parts))
        done = [bool(x) for x in flat[:q]]
        its = flat[q:2 * q]
        d = len(rows)
        gmodes = flat[2 * q:2 * q + d]
        plans = []
        off = 2 * q + d
        for masks in plan_masks:
            k = len(masks) + 1
            f = flat[off:off + k]
            off += k
            plans.append(_ScanPlan(bool(f[0]), masks, [bool(x) for x in f[1:]]))
        return done, its, gmodes, plans

    # -- execution -----------------------------------------------------------

    def _step_rows(self, rows, gmodes, plans, which, tele_global: bool) -> tuple:
        """Step the query shards listed in `which` (the others keep their
        state). Replicated: the global or local step on every shard.
        Edge-sharded: each listed shard's scan over its edge shards; its
        telemetry increment is summed over every listed shard into the
        global accumulator (`tele_global`, the host-stepped path) or kept
        on the shard (the fused run, globalized at exit)."""
        if self.placement == "replicated":
            step = _make_replicated_step(self.program, self.cfg, self.n_edges,
                                         self.consensus)
            if self.consensus == "global":
                return step(rows, self.row_views, gmodes)
            out = list(rows)
            for d in which:
                out[d] = step((rows[d],), (self.row_views[d],), (gmodes[d],))[0]
            return tuple(out)
        step = _make_edge_sharded_step(self.program, self.cfg, self.n, self.n_edges)
        out = list(rows)
        incs = []
        for d in which:
            plan = plans[d] if plans else None
            deg = self.deg.to(self.row_devices[d])
            out[d], inc = step(rows[d], self.shard_views(d), deg, plan)
            incs.append(inc)
            if inc is not None and not tele_global:
                out[d] = out[d]._replace(tele=_add_host_tele(out[d].tele, inc))
        if tele_global and rows[0].tele is not None:
            total = [sum(x) for x in zip(*incs)]
            tele = _add_host_tele(rows[0].tele, total)
            out = [r._replace(tele=tele.to(r.done.device)) for r in out]
        return tuple(out)

    def step(self, rows: Sequence[B.BatchState], flags=None) -> tuple:
        """One batched iteration of every shard (the scheduler's
        host-stepped path). Needs the global controller, except for edge
        shards. `flags` is this state's `flags()` where the caller has read
        it; without it the step reads them (counted in HOST_READS['gmode'])."""
        assert self.consensus == "global" or self.placement == "edge_sharded"
        if flags is None:
            flags = self.flags(rows)
            B.HOST_READS["gmode"] += 1
        _done, _its, gmodes, plans = flags
        return self._step_rows(tuple(rows), gmodes, plans,
                               range(len(rows)), tele_global=True)

    def run(self, rows: Sequence[B.BatchState]):
        """Advance `rows` to convergence; returns (metadata, stats) of the
        global state, fields (n+1, Q) on shard 0's device.

        Global consensus steps every query shard until no lane of any is
        live (the single-device loop's schedule); local consensus and edge
        shards step each query shard until its own lanes are done, then
        normalize the consensus scalars."""
        rows = tuple(rows)
        lockstep = self.placement == "replicated" and self.consensus == "global"
        per = rows[0].done.shape[0]
        while True:
            done, _its, gmodes, plans = self.flags(rows)
            B.HOST_READS["loop"] += 1
            live = [not all(done[d * per:(d + 1) * per]) for d in range(len(rows))]
            if not any(live):
                break
            which = range(len(rows)) if lockstep else [d for d in range(len(rows)) if live[d]]
            rows = self._step_rows(rows, gmodes, plans, which, tele_global=False)
        if not lockstep:
            rows = _normalize_scalars(rows, self.n_edge_shards)
        final = self.gather(rows)
        stats = {
            "iterations": final.it.max(),
            "per_query_iters": final.it,
            "push_iters": final.push_iters,
            "pull_iters": final.pull_iters,
            "switches": final.switches,
            "final_count": final.count,
            "mode_trace": final.mode_trace,
            "tele": final.tele,
        }
        return final.m, stats

    def pack_pump(self, rows: Sequence[B.BatchState]) -> torch.Tensor:
        """`scheduler._pack_pump` of the global state without gathering its
        planes: [gmode, union_fe, overflow, live lanes, tele, per-lane
        frontier counts], the replicated fields from query shard 0."""
        i64 = torch.int64
        r0 = rows[0]
        dev = r0.done.device
        head = torch.stack([r0.gmode.to(i64), r0.union_fe.to(i64), r0.overflow.to(i64),
                            _live_count(rows).to(i64)])
        tele = (r0.tele if r0.tele is not None
                else torch.zeros((TELE_LEN,), dtype=i64, device=dev))
        return torch.cat([head, tele.to(i64)] + [r.count.to(i64).to(dev) for r in rows])


def run_sharded(program: ACCProgram, g: Graph, pack: EllPack, cfg: EngineConfig,
                mesh: ServingMesh, sources, *, placement: str = "replicated",
                consensus: str = "global", delta: Optional[EdgeDelta] = None):
    """`run_batch`, sharded: Q point queries to convergence on `mesh`.
    Returns (metadata dict, field -> global (n+1, Q), stats)."""
    eng = ShardedBatchEngine(program, g, pack, cfg, mesh, placement=placement,
                             consensus=consensus, delta=delta)
    return eng.run(eng.init(sources))


def shard_sources(sources, n_shards: int) -> list:
    """The per-shard source slices a ('data' = n_shards) mesh assigns: shard
    d owns the contiguous block sources[d*Q/D : (d+1)*Q/D]."""
    sources = list(sources)
    q = len(sources)
    assert q % n_shards == 0, (q, n_shards)
    per = q // n_shards
    return [sources[d * per:(d + 1) * per] for d in range(n_shards)]
