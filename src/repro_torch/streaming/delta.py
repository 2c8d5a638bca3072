"""Dynamic graphs: a delta overlay over a static base CSR.

Port of `repro.streaming.delta` (DESIGN.md §8). SIMD-X's central move —
absorb an irregular stream into bounded static structure, with an overflow
path to a fallback — applied to graph MUTATION:

  * **Deletions** neutralize base-edge slots: the CSR view's `col_idx`
    becomes the scratch sentinel `n` (weight 0), and the packed ELL slot
    likewise, so a deleted edge stops contributing. Shapes never change.
  * **Insertions** land in two bounded buffers: a width-1 delta ELL slice
    appended to the pull pack (`graph/packing.delta_ell_slice`) and a COO
    :class:`EdgeDelta` appended to the push edge buffer.
  * **Overflow** of the insertion budget rebuilds the CSR and repacks the
    ELL slices (compaction), clearing the overlay.

Where the state lives. The reference keeps full host copies (the CSR, every
packed slot, the edge -> slot map) and re-uploads the whole neutralized CSR
on every batch that deletes. Here the device holds the base graph, its ELL
pack, the edge -> slot map (`_pack_pos`) and every view. A view that a batch
changes is a `clone()` of the current view plus one index write of the
slots that batch deleted, so a changed view is a new tensor and an
unchanged one keeps its identity. The host holds the update log — the
deleted base out-edge positions (`_dead_pos_out`), the pending
insertions (`_ins`) — and the CSRs' `row_ptr`/`col_idx`, which
`_find_edges` binary-searches for each update edge. The O(m) helpers
(`_boundary_of`, `live_edges_coo`, the device sweep, `begin_compact`) run
with torch on the graph's device; `live_out_degrees`,
`live_out_neighbors`, `n_live_edges` and `stats` need only the log.

Every view, report and sweep is array-equal to the reference's for the same
graph and the same update batches (tests/test_torch_streaming.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.graph.csr import CSR, Graph, delta_from_edges, from_edges
from repro_torch.graph.packing import (
    DEFAULT_BUCKETS,
    DEFAULT_SPLIT,
    EllPack,
    EllSlice,
    delta_ell_slice,
    pack_ell_with_positions,
)
from repro_torch.obs.recorder import record_global


@dataclasses.dataclass(frozen=True)
class UpdateReport:
    """What one `apply` batch did, plus the sweeps downstream layers consume."""

    version: int                 # graph version AFTER the batch
    n_inserted: int              # directed insertions absorbed (post-expansion)
    n_deleted: int               # directed deletions applied
    n_ignored: int               # duplicate inserts / missing deletes skipped
    rebuild: bool                # overlay overflowed -> CSR rebuild + repack
    touched: np.ndarray          # endpoint vertex ids of this batch's edges
    #: (n,) bool — source s is DIRTY iff s can reach a touched endpoint
    #: (reverse-reachability over the union of old and new edges): any
    #: single-source result from a clean source is bitwise unaffected.
    dirty_src: np.ndarray
    #: (n,) bool — vertices whose monotone fixpoint values may need repair
    #: after a DELETION (forward-reachable from deleted-edge heads). Empty
    #: for insert-only batches.
    affected_del: np.ndarray
    #: inserted directed edges' source endpoints (monotone re-seed set)
    ins_src: np.ndarray
    #: clean (not in affected_del) vertices with a live edge into the
    #: affected region — the boundary that re-pushes final values into it.
    boundary: np.ndarray
    #: APPLIED directed insertions, (k, 2) int64 (u, v) rows
    ins_edges: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))
    #: APPLIED directed deletions, (k, 2) int64 (u, v) rows
    del_edges: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))

    @property
    def insert_only(self) -> bool:
        return self.n_deleted == 0


def _find_edges(rp: np.ndarray, ci: np.ndarray, u: np.ndarray, v: np.ndarray):
    """Positions of directed edges (u, v) in a CSR with sorted row segments;
    -1 where absent. A binary search per edge."""
    lo = rp[u]
    hi = rp[u + 1]
    pos = np.full(u.shape[0], -1, dtype=np.int64)
    for i in range(u.shape[0]):          # update batches are small
        s = np.searchsorted(ci[lo[i]:hi[i]], v[i]) + lo[i]
        if s < hi[i] and ci[s] == v[i]:
            pos[i] = s
    return pos


def _csr_expand(rp: np.ndarray, ci: np.ndarray, frontier: np.ndarray):
    lens = rp[frontier + 1] - rp[frontier]
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=ci.dtype)
    starts = np.repeat(rp[frontier], lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return ci[starts + offs]


def _reach_fixpoint_device(src_e: torch.Tensor, dst_e: torch.Tensor,
                           xsrc: torch.Tensor, xdst: torch.Tensor, n: int,
                           seed: torch.Tensor) -> torch.Tensor:
    """Device counterpart of :func:`_reach`: all seeds expand together over
    the (src, dst) edge list plus the extra COO edges, every edge every
    level, to the fixpoint. A level is one int32 gather of `reach` at the
    senders and one int32 scatter-max at the receivers, the reference's
    scatter-max: a receiver is reached iff a reached sender points at it (an
    OR, order-free), so the set equals the host sweep's. One host read a
    level (`any` changed).
    The reference's `lax.while_loop` needs a static extra-COO pad of
    `delta_cap` lanes; torch does not, so the extras are the pending
    insertions as they are."""
    reach = seed
    while True:
        hop = torch.zeros_like(reach)
        hop.index_reduce_(0, dst_e, reach.index_select(0, src_e), "amax")
        if xsrc.numel():
            hop.index_reduce_(0, xdst, reach.index_select(0, xsrc), "amax")
        hop[-1] = 0
        new = torch.maximum(reach, hop)
        changed = bool((new != reach).any())
        reach = new
        if not changed:
            return reach


def _reach(rp, ci, xsrc, xdst, n, seeds) -> np.ndarray:
    """(n,) bool forward-reachable set (seeds included) over CSR + extra COO
    edges, on the host. Conservative union sweep for the invalidation
    tests."""
    reach = np.zeros(n, dtype=bool)
    seeds = np.asarray(seeds, dtype=np.int64)
    seeds = seeds[(seeds >= 0) & (seeds < n)]
    if seeds.size == 0:
        return reach
    reach[seeds] = True
    frontier = np.unique(seeds)
    while frontier.size:
        nxt = _csr_expand(rp, ci, frontier)
        if xsrc.size:
            in_f = np.zeros(n, dtype=bool)
            in_f[frontier] = True
            nxt = np.concatenate([nxt, xdst[in_f[xsrc]]])
        nxt = np.unique(nxt.astype(np.int64))
        nxt = nxt[~reach[nxt]]
        reach[nxt] = True
        frontier = nxt
    return reach


def _neutralized(csr: CSR, pos: list, n: int) -> CSR:
    """A CSR view with the edges at `pos` neutralized (col n, weight 0):
    new col/weight tensors, the row arrays shared."""
    idx = torch.tensor(pos, dtype=torch.long, device=csr.device)
    col = csr.col_idx.clone()
    col[idx] = n
    w = csr.weights.clone()
    w[idx] = 0.0
    return CSR(csr.row_ptr, col, w, csr.src_idx)


class StreamingGraph:
    """Mutable graph = immutable base + bounded overlay.

    Device-facing views (`graph`, `pack`, `delta`) keep STATIC shapes across
    update batches; only an overflow rebuild re-buckets the ELL pack. They
    live on the device of the graph given.
    """

    #: edge count above which 'auto' sweeps run on the device (below it the
    #: host loop wins: the device fixpoint scans EVERY edge a level)
    DEVICE_SWEEP_MIN_EDGES = 1 << 15

    def __init__(
        self,
        g: Graph,
        delta_cap: int = 256,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        split: int = DEFAULT_SPLIT,
        min_rows: int = 8,
        sweep: str = "auto",
    ):
        assert delta_cap >= 1
        assert sweep in ("auto", "host", "device"), sweep
        self.n = g.n_nodes
        self.device = g.device
        self.delta_cap = delta_cap
        self.sweep = sweep
        self._buckets = tuple(buckets)
        self._split = split
        self._min_rows = min_rows
        # in-flight rebuild state (begin_compact/finish_compact)
        self._rebuild_inflight: Optional[Graph] = None
        self._replay_ops: list = []
        self._replay_reports: list = []
        #: storage sharing (out/in CSR are the same tensors) — affects how
        #: deletions locate packed slots; a rebuild separates the storage.
        self.symmetric = g.inc is g.out
        #: logical directedness — an undirected edge update always expands to
        #: both directions, even after a rebuild separated the storage.
        self.undirected = g.inc is g.out
        self.version = 0
        self.rebuilds = 0
        self.last_report: Optional[UpdateReport] = None
        self._install_base(g)

    # -- base installation / rebuild ------------------------------------

    def _install_base(self, g: Graph) -> None:
        self._base = g
        # host copies for `_find_edges` and the host sweep
        self._out_rp = obs.host_copy(g.out.row_ptr)
        self._out_ci = obs.host_copy(g.out.col_idx)
        if g.inc is g.out:
            self._inc_rp, self._inc_ci = self._out_rp, self._out_ci
        else:
            self._inc_rp = obs.host_copy(g.inc.row_ptr)
            self._inc_ci = obs.host_copy(g.inc.col_idx)
        # the update log: deleted base out-edge positions
        self._dead_pos_out: set = set()
        # deletions not yet written into the views: out/inc CSR positions,
        # and in-edge positions whose packed slot is to neutralize
        self._new_dead_out: list = []
        self._new_dead_inc: list = []
        self._new_dead_slots: list = []
        # the views start as the base's own tensors (nothing is dead yet)
        self._out_view: CSR = g.out
        self._inc_view: CSR = g.inc
        self._delta_cache = None
        self._dslice_cache = None
        self._dirty_ins = True
        # device-sweep residents per direction: the pristine CSR's per-edge
        # (row, col) ids — deleted edges stay in the union sweep by design
        self._sweep_dev: dict = {}
        # pending insertions, directed view: (src, dst, w) triples
        self._ins: list[Tuple[int, int, float]] = []
        base_pack, pos = pack_ell_with_positions(
            g.inc, self._buckets, self._split, self._min_rows)
        self._pack_pos = pos                     # inc-edge -> (slice, row, col)
        # a rebuild re-buckets the pack: the slice list takes the NEW count
        self._slices_dev = list(base_pack.slices)
        self._materialize()

    def _materialize(self) -> None:
        """Refresh the device-facing views. Identity-stable: a view tensor
        is re-created ONLY when this batch changed what backs it (deletions
        the CSR views and the slices they hit, insertion-buffer changes the
        delta views); everything else keeps the same tensor objects."""
        n = self.n
        if self._new_dead_out:
            self._out_view = _neutralized(self._out_view, self._new_dead_out, n)
            self._new_dead_out = []
        if self.symmetric:
            self._inc_view = self._out_view
        elif self._new_dead_inc:
            self._inc_view = _neutralized(self._inc_view, self._new_dead_inc, n)
            self._new_dead_inc = []
        self.graph = Graph(out=self._out_view, inc=self._inc_view)

        if self._new_dead_slots:
            idx = torch.tensor(self._new_dead_slots, dtype=torch.long,
                               device=self.device)
            where = obs.host_copy(self._pack_pos[idx])           # (k, 3): one read
            self._new_dead_slots = []
            for si in np.unique(where[:, 0]):
                if si < 0:
                    continue
                hit = where[where[:, 0] == si]
                r = torch.from_numpy(hit[:, 1]).to(self.device)
                c = torch.from_numpy(hit[:, 2]).to(self.device)
                s = self._slices_dev[si]
                nbr = s.nbr.clone()
                nbr[r, c] = n
                wgt = s.wgt.clone()
                wgt[r, c] = 0.0
                self._slices_dev[si] = EllSlice(nbr, wgt, s.row_id,
                                                rows_ascending=s.rows_ascending)
        if self._dirty_ins or self._delta_cache is None:
            ins = np.asarray(self._ins, dtype=np.float64).reshape(-1, 3)
            # pull-side delta slice: receivers are rows (inc direction)
            self._dslice_cache = delta_ell_slice(
                dst=ins[:, 1], src=ins[:, 0], w=ins[:, 2], n=n,
                cap=self.delta_cap, min_rows=self._min_rows, device=self.device)
            self._delta_cache = delta_from_edges(
                ins[:, 0], ins[:, 1], ins[:, 2], n, self.delta_cap,
                device=self.device)
            self._dirty_ins = False
        self.pack = EllPack(
            slices=tuple(self._slices_dev) + (self._dslice_cache,), n_nodes=n)
        self.delta = self._delta_cache

    def compact(self) -> "UpdateReport":
        """Fold the overlay into a fresh base CSR + ELL pack (the overflow
        escape path; also callable explicitly) — the synchronous
        :meth:`begin_compact` + :meth:`finish_compact` pair."""
        self.begin_compact()
        return self.finish_compact()

    def begin_compact(self) -> None:
        """Start an overlay rebuild IN FLIGHT: fold a snapshot of the current
        overlay into a fresh CSR WITHOUT installing it. Update batches
        applied before :meth:`finish_compact` keep landing in the live
        overlay and are recorded for replay, so the finish MERGES them into
        the rebuilt base. The fold runs on the device: the live base edges
        in CSR order, then the pending insertions in buffer order."""
        assert self._rebuild_inflight is None, "rebuild already in flight"
        out = self._base.out
        live = self._live_mask()
        src = out.src_idx[live].long()
        dst = out.col_idx[live].long()
        w = out.weights[live]
        if self._ins:
            ins = np.asarray(self._ins, dtype=np.float64).reshape(-1, 3)
            src = torch.cat([src, torch.from_numpy(ins[:, 0].astype(np.int64)).to(self.device)])
            dst = torch.cat([dst, torch.from_numpy(ins[:, 1].astype(np.int64)).to(self.device)])
            w = torch.cat([w, torch.from_numpy(ins[:, 2].astype(np.float32)).to(self.device)])
        self._rebuild_inflight = from_edges(src, dst, self.n, w, directed=True,
                                            dedupe=False, device=self.device)
        self._replay_ops = []
        self._replay_reports = []

    def finish_compact(self) -> "UpdateReport":
        """Install the in-flight rebuild, replaying every batch applied
        since :meth:`begin_compact` onto the rebuilt base — each applied
        edge exactly ONCE (the pre-begin overlay is already folded in).
        Returns one merged :class:`UpdateReport` for everything absorbed
        since begin (`rebuild=True` signals the view-identity change; the
        counts are zero when nothing arrived mid-flight). The logical graph
        is unchanged by the install itself, so the version is NOT bumped."""
        assert self._rebuild_inflight is not None, "no rebuild in flight"
        g2 = self._rebuild_inflight
        ops = self._replay_ops
        reports = self._replay_reports
        self._rebuild_inflight = None
        self._replay_ops = []
        self._replay_reports = []
        self.rebuilds += 1
        self.symmetric = False       # rebuilt graphs carry separate in-CSR
        self._install_base(g2)
        for ins_list, del_list in ops:
            for (u, v) in del_list:           # apply order: deletes first
                self._delete_one(u, v)
            for (u, v, w) in ins_list:
                if not self._edge_live(u, v):
                    self._ins.append((u, v, w))
                    self._dirty_ins = True
        if len(self._ins) > self.delta_cap:
            # the replayed mid-flight insertions overflow the fresh overlay
            # too: fold again synchronously
            self.compact()
        elif ops:
            self._materialize()
        return self._merged_report(reports)

    def _merged_report(self, reports) -> "UpdateReport":
        """One coherent UpdateReport for a begin..finish compaction window:
        counts summed, endpoint/dirty sets unioned across the mid-flight
        batches."""
        empty = np.zeros(0, dtype=np.int64)
        if not reports:
            rep = UpdateReport(
                version=self.version, n_inserted=0, n_deleted=0, n_ignored=0,
                rebuild=True, touched=empty,
                dirty_src=np.zeros(self.n, dtype=bool),
                affected_del=np.zeros(self.n, dtype=bool),
                ins_src=empty, boundary=empty)
        else:
            rep = UpdateReport(
                version=self.version,
                n_inserted=sum(r.n_inserted for r in reports),
                n_deleted=sum(r.n_deleted for r in reports),
                n_ignored=sum(r.n_ignored for r in reports),
                rebuild=True,
                touched=np.unique(np.concatenate(
                    [r.touched for r in reports] + [empty])),
                dirty_src=np.logical_or.reduce(
                    [r.dirty_src for r in reports]),
                affected_del=np.logical_or.reduce(
                    [r.affected_del for r in reports]),
                ins_src=np.unique(np.concatenate(
                    [r.ins_src for r in reports] + [empty])),
                boundary=np.unique(np.concatenate(
                    [r.boundary for r in reports] + [empty])),
                ins_edges=np.concatenate(
                    [r.ins_edges for r in reports]).reshape(-1, 2),
                del_edges=np.concatenate(
                    [r.del_edges for r in reports]).reshape(-1, 2),
            )
        self.last_report = rep
        return rep

    def _dead_out_positions(self) -> np.ndarray:
        """Sorted int64 positions of the deleted base out-edges."""
        return np.sort(np.fromiter(self._dead_pos_out, np.int64,
                                   len(self._dead_pos_out)))

    @property
    def _dead_out(self) -> torch.Tensor:
        """(m,) bool on the device: the deleted base out-edges."""
        return ~self._live_mask()

    def _live_mask(self) -> torch.Tensor:
        live = torch.ones(self._out_ci.shape[0], dtype=torch.bool, device=self.device)
        if self._dead_pos_out:
            live[torch.from_numpy(self._dead_out_positions()).to(self.device)] = False
        return live

    # -- the update batch ------------------------------------------------

    def apply(self, inserts: Iterable = (), deletes: Iterable = ()) -> UpdateReport:
        """Absorb one batch of edge updates; returns the :class:`UpdateReport`
        consumed by incremental recomputation and cache invalidation.

        `inserts`: iterables of (u, v) or (u, v, w); `deletes`: (u, v).
        On a symmetric base both directions are updated. Inserting a live
        edge or deleting a missing one is counted in `n_ignored`.
        """
        ins_d, del_d, ignored = self._expand_directed(inserts, deletes)

        n_del = 0
        applied_del: list[tuple[int, int]] = []
        for (u, v) in del_d:
            if self._delete_one(u, v):
                n_del += 1
                applied_del.append((u, v))
            else:
                ignored += 1

        n_ins = 0
        applied_ins: list[tuple[int, int, float]] = []
        for (u, v, w) in ins_d:
            if self._edge_live(u, v) or any(
                    (u, v) == (iu, iv) for (iu, iv, _w) in self._ins):
                ignored += 1
                continue
            self._ins.append((u, v, w))
            self._dirty_ins = True
            n_ins += 1
            applied_ins.append((u, v, w))

        if self._rebuild_inflight is not None:
            # a rebuild is in flight: this batch landed in the live overlay
            # above AND is recorded for replay into the rebuilt base
            self._replay_ops.append((list(applied_ins), list(applied_del)))

        touched = np.unique(np.asarray(
            [e[0] for e in ins_d] + [e[1] for e in ins_d]
            + [e[0] for e in del_d] + [e[1] for e in del_d],
            dtype=np.int64))
        del_heads = np.unique(np.asarray(
            [v for (_u, v) in del_d], dtype=np.int64))
        ins_src = np.unique(np.asarray(
            [u for (u, _v, _w) in ins_d], dtype=np.int64))

        # sweeps run over the UNION graph (deleted edges still present in the
        # pristine base arrays; insertions as extra COO) — conservative
        dirty_src = self._sweep("reverse", touched)
        if del_heads.size:
            affected = self._sweep("forward", del_heads)
        else:
            affected = np.zeros(self.n, dtype=bool)

        rebuild = len(self._ins) > self.delta_cap
        if rebuild:
            if self._rebuild_inflight is not None:
                # the overflowing batch is already recorded for replay:
                # merge it into the in-flight rebuild
                self.finish_compact()
            else:
                self.compact()
        else:
            self._materialize()
        self.version += 1
        boundary = self._boundary_of(affected)
        self.last_report = UpdateReport(
            version=self.version, n_inserted=n_ins, n_deleted=n_del,
            n_ignored=ignored, rebuild=rebuild, touched=touched,
            dirty_src=dirty_src, affected_del=affected, ins_src=ins_src,
            boundary=boundary,
            ins_edges=np.asarray(
                [(u, v) for (u, v, _w) in applied_ins],
                np.int64).reshape(-1, 2),
            del_edges=np.asarray(applied_del, np.int64).reshape(-1, 2),
        )
        if self._rebuild_inflight is not None:
            self._replay_reports.append(self.last_report)
        record_global("stream_apply", version=self.version,
                      inserted=n_ins, deleted=n_del, ignored=ignored,
                      rebuild=rebuild, touched=int(touched.size))
        return self.last_report

    # -- affected-region sweeps -----------------------------------------

    def _sweep(self, direction: str, seeds: np.ndarray) -> np.ndarray:
        """Forward/reverse reachable set over the union graph, on the host
        (:func:`_reach`) or the device (:func:`_reach_fixpoint_device`) by
        the `sweep` policy: 'auto' takes the device for graphs of at least
        `DEVICE_SWEEP_MIN_EDGES` edges, the host below. Both return the
        same set. An overflowing batch sweeps on the device too (the
        reference takes the host there: its device path has a static pad
        of `delta_cap` extra lanes)."""
        xsrc, xdst = self._ins_coo()
        if direction == "reverse":
            rp, ci, xs, xd, csr = self._inc_rp, self._inc_ci, xdst, xsrc, self._base.inc
        else:
            rp, ci, xs, xd, csr = self._out_rp, self._out_ci, xsrc, xdst, self._base.out
        on_device = self.sweep == "device" or (
            self.sweep == "auto" and ci.shape[0] >= self.DEVICE_SWEEP_MIN_EDGES)
        if not on_device:
            return _reach(rp, ci, xs, xd, self.n, seeds)
        if direction not in self._sweep_dev:
            # the pristine CSR's own (row, col) tensors: no upload, no copy
            self._sweep_dev[direction] = (csr.src_idx, csr.col_idx)
        src_e, dst_e = self._sweep_dev[direction]
        seeds = np.asarray(seeds, dtype=np.int64)
        seeds = seeds[(seeds >= 0) & (seeds < self.n)]
        seed = torch.zeros(self.n + 1, dtype=torch.int32, device=self.device)
        seed[torch.from_numpy(seeds).to(self.device)] = 1
        reach = _reach_fixpoint_device(
            src_e, dst_e, torch.from_numpy(xs.astype(np.int32)).to(self.device),
            torch.from_numpy(xd.astype(np.int32)).to(self.device), self.n, seed)
        return obs.host_copy(reach[:self.n].bool())

    # -- helpers ---------------------------------------------------------

    def _expand_directed(self, inserts, deletes):
        ins_d, del_d = [], []
        ignored = 0
        for e in inserts:
            u, v = int(e[0]), int(e[1])
            w = float(e[2]) if len(e) > 2 else 1.0
            if u == v or not (0 <= u < self.n and 0 <= v < self.n):
                ignored += 1
                continue
            ins_d.append((u, v, w))
            if self.undirected:
                ins_d.append((v, u, w))
        for e in deletes:
            u, v = int(e[0]), int(e[1])
            if u == v or not (0 <= u < self.n and 0 <= v < self.n):
                ignored += 1
                continue
            del_d.append((u, v))
            if self.undirected:
                del_d.append((v, u))
        return ins_d, del_d, ignored

    def _edge_live(self, u: int, v: int) -> bool:
        pos = _find_edges(self._out_rp, self._out_ci,
                          np.asarray([u]), np.asarray([v]))[0]
        return pos >= 0 and int(pos) not in self._dead_pos_out

    def _delete_one(self, u: int, v: int) -> bool:
        """Delete the directed edge (u, v) from the log; its views are
        written at the next `_materialize`."""
        # a pending insert just gets dropped from the buffer
        for i, (iu, iv, _w) in enumerate(self._ins):
            if (iu, iv) == (u, v):
                self._ins.pop(i)
                self._dirty_ins = True
                return True
        pos = int(_find_edges(self._out_rp, self._out_ci,
                              np.asarray([u]), np.asarray([v]))[0])
        if pos < 0 or pos in self._dead_pos_out:
            return False
        self._dead_pos_out.add(pos)
        self._new_dead_out.append(pos)
        # neutralize the packed slot of the matching in-edge (v <- u)
        ipos = pos if self.symmetric else int(_find_edges(
            self._inc_rp, self._inc_ci, np.asarray([v]), np.asarray([u]))[0])
        if ipos >= 0:
            if not self.symmetric:
                self._new_dead_inc.append(ipos)
            self._new_dead_slots.append(ipos)
        return True

    def _ins_coo(self):
        if not self._ins:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        ins = np.asarray(self._ins, dtype=np.float64).reshape(-1, 3)
        return ins[:, 0].astype(np.int64), ins[:, 1].astype(np.int64)

    def live_out_degrees(self) -> np.ndarray:
        """(n,) int64 live out-degrees of the CURRENT overlaid graph: base
        degrees minus deleted base edges plus pending insertions (the host
        counterpart of `graph.csr.live_degrees` on the device views), from
        the update log alone."""
        n = self.n
        deg = np.diff(self._out_rp).astype(np.int64)
        if self._dead_pos_out:
            rows = np.searchsorted(self._out_rp, self._dead_out_positions(),
                                   side="right") - 1
            deg -= np.bincount(rows, minlength=n)[:n]
        xs, _ = self._ins_coo()
        if xs.size:
            deg += np.bincount(xs, minlength=n)[:n]
        return deg

    def live_edges_coo(self) -> tuple:
        """(src, dst) int64 tensors on the graph's device: ALL live directed
        edges of the current overlaid graph — base minus deleted edges, in
        CSR order, then the pending insertions, parallel-edge multiplicity
        kept (the reference returns the same arrays in numpy)."""
        out = self._base.out
        live = self._live_mask()
        src = out.src_idx[live].long()
        dst = out.col_idx[live].long()
        xsrc, xdst = self._ins_coo()
        if xsrc.size:
            src = torch.cat([src, torch.from_numpy(xsrc).to(self.device)])
            dst = torch.cat([dst, torch.from_numpy(xdst).to(self.device)])
        return src, dst

    def live_out_neighbors(self, u: int) -> np.ndarray:
        """Live out-neighbor ids of `u` in the current overlaid graph."""
        lo, hi = int(self._out_rp[u]), int(self._out_rp[u + 1])
        alive = np.ones(hi - lo, dtype=bool)
        if self._dead_pos_out:
            dead = self._dead_out_positions()
            dead = dead[(dead >= lo) & (dead < hi)]
            alive[dead - lo] = False
        cols = self._out_ci[lo:hi][alive].astype(np.int64)
        extra = np.asarray([v for (iu, v, _w) in self._ins if iu == u],
                           dtype=np.int64)
        return np.concatenate([cols, extra]) if extra.size else cols

    def _boundary_of(self, affected: np.ndarray) -> np.ndarray:
        """Clean vertices with a LIVE out-edge into the affected region: one
        pass over the base edges on the device (a scatter-max of qualifying
        edges a sender marks it), the pending insertions on the host."""
        if not affected.any():
            return np.zeros(0, dtype=np.int64)
        n = self.n
        out = self._base.out
        aff = torch.from_numpy(affected).to(self.device)
        sel = (aff.index_select(0, out.col_idx) & ~aff.index_select(0, out.src_idx)
               & self._live_mask())
        hits = torch.zeros(n, dtype=torch.int32, device=self.device)
        hits.index_reduce_(0, out.src_idx, sel.to(torch.int32), "amax")
        base = np.flatnonzero(obs.host_copy(hits) > 0).astype(np.int64)
        xsrc, xdst = self._ins_coo()
        extra = xsrc[affected[xdst] & ~affected[xsrc]]
        return np.union1d(base, extra)

    def delta_shards(self, n_shards: int):
        """Per-shard views of the insertion overlay for edge-partitioned
        pools (serving/sharded.py): the (cap,) COO lanes round-robined into
        (n_shards, ceil(cap/n_shards)) slices, each inserted edge owned by
        exactly one shard. Shapes depend only on (delta_cap, n_shards)."""
        from repro_torch.graph.partition import shard_delta

        return shard_delta(self.delta, n_shards, self.n)

    # -- reporting -------------------------------------------------------

    def n_live_edges(self) -> int:
        return self._out_ci.shape[0] - len(self._dead_pos_out) + len(self._ins)

    def stats(self) -> dict:
        return {
            "version": self.version,
            "n_nodes": self.n,
            "base_edges": int(self._out_ci.shape[0]),
            "deleted": len(self._dead_pos_out),
            "inserted": len(self._ins),
            "delta_cap": self.delta_cap,
            "delta_fill": len(self._ins) / self.delta_cap,
            "rebuilds": self.rebuilds,
        }
