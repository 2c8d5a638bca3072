"""Pool placement: sharded serving pools behind the GraphServer (DESIGN.md §9).

Port of `repro.serving.placement`. Unplaced pools stay the single-device
`AlgoPool`; placed pools wrap a :class:`~repro_torch.serving.sharded.
ShardedBatchEngine` on the server's ('data', 'model') mesh:

    Placement('replicated', 8)    # query-sharded: Q over 8 'data' shards,
                                  # graph/pack/delta on every query shard
    Placement('edge_sharded', 4)  # 1-D edge partition over 4 'model' shards

The scheduler's contract is unchanged — free_lanes / admit / step / harvest
/ set_graph / readmit — so admission, continuous batching, backpressure and
`apply_updates` run through sharded pools untouched. Two placement-specific
behaviours:

  * **shard-local lane routing**: lane l of a Q-lane pool lives on 'data'
    shard l // (Q/D), so `free_lanes` orders free lanes round-robin across
    shards and admissions spread over the mesh;
  * **cache keys**: edge-sharded pools of sum programs give results that
    differ from the single-device bits by the shard fold, so their cache
    entries carry a ('placement', 'edge_sharded') param.

The pool's state is the engine's: one BatchState a query shard. The hot
paths (the packed read, the step, admission, harvest, telemetry) work on
the shards' states; the rare ones (preemption, resume, residual resume,
the masked-pull cache reset) work on the gathered global state through the
`state` property, exactly as on one device, and split it back.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch import obs
from repro_torch.core.acc import ACCProgram
from repro_torch.core.engine import EngineConfig
from repro_torch.graph.csr import EdgeDelta, Graph, live_degrees
from repro_torch.graph.packing import EllPack
from repro_torch.mesh import DATA_AXIS, MODEL_AXIS, ServingMesh
from repro_torch.serving import batch_engine as B
from repro_torch.serving.scheduler import _admit_lane, _LanePool
from repro_torch.serving.sharded import ShardedBatchEngine, make_serving_mesh
from repro_torch.streaming import incremental as INC


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one pool's lanes and edges live on the serving mesh."""

    kind: str                     # 'replicated' | 'edge_sharded'
    n_shards: int = 1
    consensus: str = "global"     # pools step collectively -> global only

    def __post_init__(self):
        assert self.kind in ("replicated", "edge_sharded"), self.kind
        assert self.n_shards >= 1

    @classmethod
    def of(cls, spec) -> "Placement":
        """Coerce ('replicated'|'edge_sharded', n) tuples / bare kind strings
        (n_shards=1) / Placement instances."""
        if isinstance(spec, Placement):
            return spec
        if isinstance(spec, str):
            return cls(spec)
        kind, n_shards = spec
        return cls(kind, int(n_shards))

    def check_mesh(self, mesh: ServingMesh) -> None:
        d = int(mesh.shape[DATA_AXIS])
        s = int(mesh.shape[MODEL_AXIS])
        if self.kind == "replicated":
            assert self.n_shards == d, (
                f"replicated placement wants {self.n_shards} query shards, "
                f"mesh 'data' axis has {d}")
        else:
            assert self.n_shards == s, (
                f"edge_sharded placement wants {self.n_shards} edge shards, "
                f"mesh 'model' axis has {s}")


class ShardedAlgoPool(_LanePool):
    """Fixed query slots for one ACC program, sharded across a mesh.
    `slots` is the total lane count across query shards (it must divide by
    the mesh's 'data' axis)."""

    def __init__(self, name: str, program: ACCProgram, g: Graph, pack: EllPack,
                 cfg: EngineConfig, slots: int, mesh: ServingMesh, placement,
                 result_field: Optional[str] = None,
                 delta: Optional[EdgeDelta] = None, telemetry: bool = False):
        self.placement = Placement.of(placement)
        self.placement.check_mesh(mesh)
        self.name = name
        self.program = program
        self.result_field = result_field or program.param("result", program.primary)
        self.cfg = cfg
        self.slots = slots
        self.n_query_shards = int(mesh.shape[DATA_AXIS])
        assert slots % self.n_query_shards == 0, (
            f"{slots} lanes do not divide over {self.n_query_shards} query shards")
        self._per = slots // self.n_query_shards
        self.engine = ShardedBatchEngine(
            program, g, pack, cfg, mesh, placement=self.placement.kind,
            consensus=self.placement.consensus, delta=delta, telemetry=telemetry)
        self.g, self.pack, self.delta = self.engine.g, self.engine.pack, self.engine.delta
        self.lane_rid: List[Optional[int]] = [None] * slots
        self.rows = self.engine.init([0] * slots, done=[True] * slots)
        self._mirror = None
        self._refresh_live_deg()
        #: extra cache-key params (see module docstring)
        self.cache_params = (
            (("placement", "edge_sharded"),)
            if (self.placement.kind == "edge_sharded"
                and program.combiner.name == "sum")
            else ())
        self.cache_extra_fields = tuple(
            f for f in INC.resume_fields(program) if f != self.result_field)
        self.engine_queries = 0
        self.steps = 0
        self._init_obs(telemetry)

    # -- the state: one BatchState a query shard -------------------------------

    @property
    def state(self) -> B.BatchState:
        """The global state (the shards' lanes in order; no copy on one
        query shard). Assigning a global state splits it back."""
        return self.engine.gather(self.rows)

    @state.setter
    def state(self, st: B.BatchState) -> None:
        self.rows = self.engine.split(st)

    def _set_rows(self, rows) -> None:
        self.rows = tuple(rows)
        self._mirror = None

    def _flags(self) -> tuple:
        """(done per lane, iterations per lane, gmode): the one packed read
        of every shard (`ShardedBatchEngine.flags`), kept until the next
        write."""
        if self._mirror is None:
            self._mirror = self.engine.flags(self.rows)
            B.HOST_READS["pool"] += 1
        done, its, gmodes, _plans = self._mirror
        return done, its, gmodes[0]

    def meta_fields(self) -> tuple:
        return tuple(self.rows[0].m)

    def mode_trace(self) -> torch.Tensor:
        rows = self.rows
        dev = rows[0].done.device
        return torch.cat([r.mode_trace.to(dev) for r in rows])

    def _pump_sample(self) -> torch.Tensor:
        return self.engine.pack_pump(self.rows)

    # -- scheduling interface --------------------------------------------------

    def free_lanes(self) -> List[int]:
        """Free lanes ordered round-robin across query shards, so successive
        admissions land on different shards (shard-local slot routing)."""
        per = self._per
        return sorted(super().free_lanes(), key=lambda lane: (lane % per, lane // per))

    def step(self) -> None:
        if self.live():
            self._flags()
            self._set_rows(self.engine.step(self.rows, self._mirror))
            self.steps += 1

    def _admit_state(self, lane: int, source: int) -> None:
        """Write a fresh query into `lane` of its query shard, then set the
        global consensus inputs on every shard. Edge-sharded admission is
        CSR-free: the graph's dims and the live-degree vector only."""
        d, local = divmod(lane, self._per)
        rows = list(self.rows)
        dev = rows[d].done.device
        deg = self.live_deg.to(dev)
        csr_free = self.placement.kind == "edge_sharded"
        if csr_free:
            g = B.GraphDims(self.engine.n, self.engine.n_edges)
        else:
            g = self.engine.row_views[d][0]
        rows[d] = _admit_lane(self.program, g, self.cfg, rows[d], source, local,
                              deg=deg, check_caps=not csr_free, consensus=False)
        self._set_rows(self.engine.sync_consensus(rows, csr_free))

    def harvest(self) -> List[tuple]:
        """(lane, rid, result, iterations, extras) of every converged lane:
        one `index_select` a field a query shard, then each lane's row to
        the host on its own."""
        if not self.live():
            return []
        done, its, _gmode = self._flags()
        lanes = [lane for lane, rid in enumerate(self.lane_rid)
                 if rid is not None and done[lane]]
        if not lanes:
            return []
        fields = (self.result_field, *self.cache_extra_fields)
        cols = {f: {} for f in fields}
        for d, st in enumerate(self.rows):
            mine = [lane for lane in lanes if lane // self._per == d]
            if not mine:
                continue
            idx = torch.tensor([lane - d * self._per for lane in mine],
                               dtype=torch.long, device=st.done.device)
            for f in fields:
                block = st.m[f].index_select(1, idx)[:-1].T.contiguous()
                for lane, row in zip(mine, block):
                    cols[f][lane] = obs.host_copy(row)
        out = []
        for lane in lanes:
            extras = {f: cols[f][lane] for f in self.cache_extra_fields}
            out.append((lane, self.lane_rid[lane], cols[self.result_field][lane],
                        its[lane], extras))
            self.lane_rid[lane] = None
        return out

    def _refresh_live_deg(self) -> None:
        # the edge-sharded engine already counted the live degrees of this
        # graph version; admission reuses them
        if self.placement.kind == "edge_sharded":
            self.live_deg = self.engine.deg
        else:
            self.live_deg = live_degrees(self.g.out, self.delta)

    # -- streaming support -----------------------------------------------------

    def set_graph(self, g: Graph, pack: EllPack, delta: Optional[EdgeDelta]) -> None:
        """Swap updated overlay views into every shard: replicated pools place
        the changed views on the query shards, edge-sharded pools re-slice
        the changed edge and overlay shards (same shapes). Masked-pull
        caches rebuild at identity as on one device."""
        self.engine.set_graph(g, pack, delta)
        self.g, self.pack, self.delta = self.engine.g, self.engine.pack, self.engine.delta
        self._refresh_live_deg()
        self._reset_masked_pull_cache()


__all__ = [
    "Placement",
    "ShardedAlgoPool",
    "make_serving_mesh",
    "DATA_AXIS",
    "MODEL_AXIS",
]
