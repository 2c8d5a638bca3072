"""The port's batched multi-query engine (`repro_torch.serving`) against the
JAX reference's (`repro.serving.batch_engine`) on the same graphs.

Lanes equal the reference's: bit for bit for bfs and sssp, within rtol 1e-5
for ppr and pagerank (sum combiners), with equal per-query iterations,
push/pull iterations, switches, `mode_trace` and telemetry counters. Inside
the port, batched lanes equal solo `engine.run` bit for bit for all four,
and the masked pull of `ppr_delta` equals its dense pull bit for bit (the
`hot` plane's promise). The Q-wide pull's plain version is bit-equal to the
reference's `_slice_partial_dense` for every op pair.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acc as jacc
from repro.core import algorithms as JA
from repro.graph import generators as jgen
from repro.graph import pack_ell as jpack
from repro.serving import batch_engine as JB
from repro.serving import default_config as jdefault
from repro_torch import interop
from repro_torch.core import algorithms as TA
from repro_torch.core import engine as TE
from repro_torch.graph import packing as tpacking
from repro_torch.kernels import ell_spmv as tell
from repro_torch.kernels import ops
from repro_torch.obs import TELE_LEN
from repro_torch.serving import batch_engine as TB
from repro_torch.serving import default_config as tdefault

SOURCES = [0, 7, 101, 511, 7]        # a duplicate; rmat(9) has 512 vertices
FIELD = {"bfs": "dist", "sssp": "dist", "ppr": "rank", "pagerank": "rank",
         "ppr_delta": "rank"}
STATS = ("per_query_iters", "push_iters", "pull_iters", "switches", "mode_trace")


def _both(jg):
    tg = interop.graph_from_numpy(interop.csr_arrays(jg.out), device="cpu")
    return jg, jpack(jg.inc), tg, tpacking.pack_ell(tg.inc)


@pytest.fixture(scope="module")
def served():
    return _both(jgen.rmat(9, 8, seed=3))


@pytest.fixture(scope="module")
def road():
    return _both(jgen.grid2d(16, seed=5))


def _progs(name):
    if name == "pagerank":
        return JA.pagerank(), TA.pagerank()
    return JA.ALL[name](0), TA.ALL[name](0)


def _cfgs(jg, tg, max_iters, **kw):
    return (dataclasses.replace(jdefault(jg, max_iters=max_iters), **kw),
            dataclasses.replace(tdefault(tg, max_iters=max_iters), **kw))


def _same_stats(sj, st):
    for k in STATS:
        assert np.array_equal(np.asarray(sj[k]), st[k].numpy()), k


def _close(name, a, b):
    if name in ("bfs", "sssp"):
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("name", ["bfs", "sssp", "ppr", "pagerank"])
def test_lanes_equal_the_reference_and_the_port_solo_engine(served, name):
    jg, jp, tg, tp = served
    jprog, tprog = _progs(name)
    cj, ct = _cfgs(jg, tg, 64)
    sources = SOURCES if name != "pagerank" else [0, 9]
    mj, sj = JB.run_batch(jprog, jg, jp, cj, sources)
    mt, st = TB.run_batch(tprog, tg, tp, ct, sources)
    f = FIELD[name]
    _close(name, np.asarray(mj[f]), mt[f].numpy())
    _same_stats(sj, st)
    if name == "pagerank":                     # source-free: one solo run
        seq = [TE.run(TA.pagerank(), tg, tp, ct)[0]] * len(sources)
    else:
        seq = TB.run_sequential(lambda: TA.ALL[name](0), tg, tp, ct, sources)
    for lane in range(len(sources)):
        for k in mt:
            assert torch.equal(mt[k][:, lane], seq[lane][k]), (lane, k)
    # the duplicate source (lanes 1 and 4), or pagerank's two lanes
    twin = (1, 4) if name != "pagerank" else (0, 1)
    assert torch.equal(TB.query_result(mt, f, twin[0]), TB.query_result(mt, f, twin[1]))


@pytest.mark.parametrize("name", ["bfs", "sssp"])
def test_road_graph_high_diameter(road, name):
    jg, jp, tg, tp = road
    jprog, tprog = _progs(name)
    cj, ct = _cfgs(jg, tg, 256)
    sources = [0, 255, 128]
    mj, sj = JB.run_batch(jprog, jg, jp, cj, sources)
    mt, st = TB.run_batch(tprog, tg, tp, ct, sources, fusion="none")
    assert np.array_equal(np.asarray(mj["dist"]), mt["dist"].numpy())
    _same_stats(sj, st)
    seq = TB.run_sequential(lambda: TA.ALL[name](0), tg, tp, ct, sources)
    for lane in range(len(sources)):
        assert torch.equal(mt["dist"][:, lane], seq[lane]["dist"])


def test_done_masking_freezes_lanes(served):
    """Lanes created done stay at their init values and cost nothing; the
    live ones equal the reference's."""
    jg, jp, tg, tp = served
    jprog, tprog = _progs("sssp")
    cj, ct = _cfgs(jg, tg, 64)
    done = [False, True, False]
    sj0 = JB.init_batch(jprog, jg, cj, [0, 5, 301], done=jnp.asarray(done))
    st0 = TB.init_batch(tprog, tg, ct, [0, 5, 301], done=done)
    mj, sj = JB.run_state(jprog, jg, jp, cj, sj0)
    mt, st = TB.run_state(tprog, tg, tp, ct, st0)
    assert np.array_equal(np.asarray(mj["dist"]), mt["dist"].numpy())
    _same_stats(sj, st)
    assert int(st["per_query_iters"][1]) == 0
    assert torch.equal(mt["dist"][:, 1], st0.m["dist"][:, 1])


@pytest.mark.parametrize("name,masked", [("bfs", False), ("ppr", True), ("ppr_delta", True)])
def test_telemetry_counters_equal_the_reference(served, name, masked):
    jg, jp, tg, tp = served
    jprog, tprog = _progs(name)
    cj, ct = _cfgs(jg, tg, 64, masked_pull=masked)
    sources = [0, 7, 101]
    mj, sj = JB.run_batch(jprog, jg, jp, cj, sources, telemetry=True)
    mt, st = TB.run_batch(tprog, tg, tp, ct, sources, telemetry=True)
    assert np.array_equal(np.asarray(sj["tele"]), st["tele"].numpy())
    assert st["tele"].shape == (TELE_LEN + 1,)
    assert int(st["tele"][TELE_LEN]) == int(st["tele"][0] + st["tele"][1])
    _same_stats(sj, st)
    _close(name, np.asarray(mj[FIELD[name]]), mt[FIELD[name]].numpy())


def test_telemetry_off_carries_no_counters(served):
    jg, jp, tg, tp = served
    _, tprog = _progs("bfs")
    _, ct = _cfgs(jg, tg, 64)
    _, st = TB.run_batch(tprog, tg, tp, ct, [0, 3])
    assert st["tele"] is None


@pytest.mark.parametrize("name", ["bfs", "ppr", "ppr_delta"])
def test_masked_pull_against_the_reference_and_the_dense_pull(served, name):
    jg, jp, tg, tp = served
    jprog, tprog = _progs(name)
    rng = np.random.default_rng(5)
    sources = rng.integers(0, jg.n_nodes, size=6).tolist()
    cj, ct = _cfgs(jg, tg, 256, masked_pull=True)
    mj, sj = JB.run_batch(jprog, jg, jp, cj, sources)
    mt, st = TB.run_batch(tprog, tg, tp, ct, sources)
    _close(name, np.asarray(mj[FIELD[name]]), mt[FIELD[name]].numpy())
    _same_stats(sj, st)
    _, ct_dense = _cfgs(jg, tg, 256)
    md, sd = TB.run_batch(tprog, tg, tp, ct_dense, sources)
    if name in ("bfs", "ppr_delta"):
        # min programs and the residual program's exact `hot` plane
        for k in md:
            assert torch.equal(md[k], mt[k]), k
        assert torch.equal(sd["mode_trace"], st["mode_trace"])
    else:
        # tol-thresholded pull program: frozen sub-tol drift, O(tol)
        assert float((md["rank"] - mt["rank"]).abs().max()) < 5e-5


def _state_arrays(state) -> dict:
    """A reference BatchState's fields as numpy arrays (`m` a dict, `pseg` a
    tuple, None planes kept)."""
    out = {}
    for k, v in state._asdict().items():
        if k == "m":
            out[k] = {f: np.asarray(a) for f, a in v.items()}
        elif k == "pseg":
            out[k] = tuple(np.asarray(a) for a in v)
        else:
            out[k] = None if v is None else np.asarray(v)
    return out


@pytest.mark.parametrize("name,steps", [("sssp", 2), ("ppr_delta", 3)])
def test_run_state_resumes_a_reference_state(served, name, steps):
    """A reference state after a few steps, carried over by
    `interop.batch_state_from_numpy`, runs to the reference's fixpoint."""
    jg, jp, tg, tp = served
    jprog, tprog = _progs(name)
    cj, ct = _cfgs(jg, tg, 128, masked_pull=name == "ppr_delta")
    sj = JB.init_batch(jprog, jg, cj, [3, 40, 200], pack=jp, telemetry=True)
    step = JB.make_batched_step(jprog, jg, jp, cj)
    for _ in range(steps):
        sj = step(sj)
    st = interop.batch_state_from_numpy(_state_arrays(sj), device="cpu")
    for k in ("hot", "pull_dense"):
        assert (getattr(st, k) is None) == (getattr(sj, k) is None), k
    assert len(st.pseg) == len(sj.pseg) and st.mode_trace.dtype == torch.int8
    mj, rj = JB.run_state(jprog, jg, jp, cj, sj)
    mt, rt = TB.run_state(tprog, tg, tp, ct, st)
    _close("sssp" if name == "sssp" else "ppr", np.asarray(mj[FIELD[name]]),
           mt[FIELD[name]].numpy())
    _same_stats(rj, rt)
    assert np.array_equal(np.asarray(rj["tele"]), rt["tele"].numpy())


def test_csr_free_init_matches_the_reference(served):
    jg, jp, tg, tp = served
    jprog, tprog = _progs("bfs")
    cj, ct = _cfgs(jg, tg, 64)
    deg = np.asarray(jg.out.row_ptr[1:] - jg.out.row_ptr[:-1])
    sj = JB.init_batch(jprog, JB.GraphDims(jg.n_nodes, jg.n_edges), cj, [0, 9],
                       deg=jnp.asarray(deg))
    st = TB.init_batch(tprog, TB.GraphDims(tg.n_nodes, tg.n_edges), ct, [0, 9],
                       deg=torch.from_numpy(deg))
    full = TB.init_batch(tprog, tg, ct, [0, 9])
    for k in ("count", "union_fe", "overflow", "mode", "gmode", "done"):
        assert np.array_equal(np.asarray(getattr(sj, k)), getattr(st, k).numpy()), k
        assert torch.equal(getattr(st, k), getattr(full, k)), k
    assert torch.equal(st.active, full.active) and torch.equal(st.m["dist"], full.m["dist"])
    with pytest.raises(ValueError):
        TB.init_batch(tprog, TB.GraphDims(tg.n_nodes, tg.n_edges), ct, [0])


def _ref_op_program(op, comb):
    """A reference program whose Compute is the named op on `val`."""
    big = tell.BIG

    def compute(sender, w, receiver):
        v = sender["val"]
        if op == "hop":
            return jnp.where(v < big, v + 1.0, big)
        if op == "add_w":
            return jnp.where(v < big, v + w, big)
        if op == "copy":
            return v
        return v * w

    return jacc.ACCProgram(name=op, combiner=jacc.Combiner(comb, "vote"), init=None,
                           compute=compute, active=None, primary="val")


@pytest.mark.parametrize("op", list(tell.COMPUTE_OPS))
def test_batched_pull_plain_equals_the_reference_slice_partial(served, op):
    """`ell_combine_batched_plain` against the reference's
    `_slice_partial_dense` on every rmat slice, for the three combines, at
    Q = 5; its Q = 1 column against the 1-D `ell_combine`."""
    jg, jp, tg, tp = served
    n = jg.n_nodes
    rng = np.random.default_rng(5)
    v = (rng.standard_normal((n + 1, 5)) * 10 ** rng.uniform(-3, 3, (n + 1, 5))).astype(np.float32)
    v[rng.random((n + 1, 5)) < 0.2] = tell.BIG
    for comb in tell.COMBINE_OPS:
        prog = _ref_op_program(op, comb)
        ident = prog.combiner.identity(jnp.float32)
        for js, ts in zip(jp.slices, tp.slices):
            want = np.asarray(JB._slice_partial_dense(prog, prog.combiner, {"val": jnp.asarray(v)},
                                                      js, n, ident))
            got = ops.ell_combine_batched(ts.nbr, ts.wgt, torch.from_numpy(v), op, comb)
            assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), (comb, ts.width)
            col = torch.from_numpy(v[:, 2:3].copy())
            one = ops.ell_combine(ts.nbr, ts.wgt, col[:, 0].contiguous(), op, comb)
            q1 = ops.ell_combine_batched(ts.nbr, ts.wgt, col, op, comb)
            assert torch.equal(q1[:, 0].contiguous().view(torch.int32), one.view(torch.int32))


def test_batched_pull_plain_chunks_rows_and_counts_no_launch(served):
    """The plain version works in row chunks (the result does not depend
    on the chunk size) and is not counted: counts are for kernels."""
    _, _, tg, tp = served
    s = tp.slices[2]
    v = torch.rand(tg.n_nodes + 1, 5, generator=torch.Generator().manual_seed(1))
    ops.reset_launches()
    whole = tell.ell_combine_batched_plain(s.nbr, s.wgt, v, "copy", "sum")
    saved = tell._PLAIN_CHUNK
    try:
        tell._PLAIN_CHUNK = s.width * 5 * 3           # three rows a chunk
        chunked = tell.ell_combine_batched_plain(s.nbr, s.wgt, v, "copy", "sum")
    finally:
        tell._PLAIN_CHUNK = saved
    assert torch.equal(whole, chunked)
    assert ops.launch_counts()["ell_combine_batched"] == 0


@pytest.mark.parametrize("q,ptr,want", [
    (64, 0, ("columns", True, 16, 2)), (8, 0, ("slots", True, 1, 32)),
    (4, 0, ("slots", True, 1, 32)), (1, 0, ("slots", False, 1, 32)),
    (3, 0, ("slots", False, 1, 32)), (65, 0, ("columns", False, 32, 1)),
    (64, 4, ("columns", False, 32, 1)), (256, 0, ("columns", True, 32, 1)),
    (2, 0, ("slots", False, 1, 32)), (16, 0, ("columns", True, 4, 4)),
    (17, 0, ("columns", False, 32, 1)), (32, 0, ("columns", True, 8, 4)),
    (128, 0, ("columns", True, 32, 1)), (130, 0, ("columns", False, 32, 1))])
def test_batched_layout_is_a_function_of_q_and_alignment(q, ptr, want):
    """Slot lanes up to SLOT_LANES_MAX_Q, column lanes beyond (G column
    lanes x S slot groups); 16-byte columns only where Q % 4 == 0 and vals
    is aligned. On a 256-wide slice (above) slot lanes take 32 lanes a row
    and column lanes p / 64 slot groups; on a 32-wide slice 8 slot lanes
    (four slots a lane) and one slot group; on a 4-wide one 2 and 1."""
    assert tell.batched_layout(q, 256, 1024 + ptr, 2048) == want
    route, vec, lanes, groups = want
    for w, slots in ((32, 8), (4, 2)):
        narrow = tell.batched_layout(q, w, 1024 + ptr, 2048)
        assert narrow == (route, vec, lanes, slots if route == "slots" else 1)


def test_fusion_and_source_checks(served):
    _, _, tg, tp = served
    _, ct = _cfgs(served[0], tg, 64)
    with pytest.raises(ValueError):
        TB.run_batch(TA.bfs(0), tg, tp, ct, [0], fusion="pushpull")
    small = dataclasses.replace(ct, frontier_cap=4)
    push_only = dataclasses.replace(TA.bfs(0), modes="push")
    with pytest.raises(ValueError):
        TB.init_batch(push_only, tg, small, [0])
