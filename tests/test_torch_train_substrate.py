"""The port's training substrate against the JAX reference on the CPU:
AdamW (`optim.adamw`), checkpoints (`checkpoint.manager`, in both
directions), the data streams, the fault guards (`distributed.fault`) and
the neighbour sampler (`graph.sampler`).

Tolerances: AdamW parameters within rtol 1e-6 and atol 1e-7, float32
moments within rtol 1e-6 and 1e-6 of the leaf's largest entry (XLA and
PyTorch take the same float32 operations, but pow, cos and the gradient
norm's sum may round differently in the last bit, and b1 m + (1 - b1) g
cancels), bfloat16 moments within one bfloat16 step (2^-7 relative), int8
moments' codes within 1 and scales within rtol 1e-6. The int8 codec, the
streams, checkpoints and the host sampler are bit-equal.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.data import pipelines as jdata
from repro.graph import sampler as jsampler
from repro.optim import adamw as jadamw
from repro_torch import interop
from repro_torch.checkpoint import manager as tckpt
from repro_torch.data import pipelines as tdata
from repro_torch.distributed import fault as tfault
from repro_torch.graph import generators as tgen
from repro_torch.graph import sampler as tsampler
from repro_torch.optim import adamw as tadamw


def _params(rng):
    return {"w": rng.standard_normal((4, 300)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "layers": [{"g": rng.standard_normal((3, 5)).astype(np.float32)},
                       {"g": rng.standard_normal((2, 2, 65)).astype(np.float32)}]}


def _grads(rng, params, scale):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        params)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_adamw_update_matches_reference_over_three_steps(moment_dtype, scale):
    """Three steps on carried params and the same gradients (scale 10:
    the global-norm clip acts), through warmup into the cosine decay."""
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    cfg = jadamw.AdamWConfig(lr=0.05, moment_dtype=moment_dtype, warmup_steps=2,
                             total_steps=5, weight_decay=0.1)
    tcfg = tadamw.AdamWConfig(**vars(cfg))
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.init(jp, cfg)
    tp = interop.params_from_numpy(p0, "cpu")
    ts = tadamw.init(tp, tcfg)
    for _ in range(3):
        g = _grads(rng, p0, scale)
        jp, js, jm = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, cfg)
        out, ts_, tm = tadamw.update(interop.params_from_numpy(g, "cpu"), ts, tp, tcfg)
        assert out is tp and ts_ is ts                      # in place
        np.testing.assert_allclose(_np(tm["grad_norm"]), np.asarray(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(_np(tm["lr"]), np.asarray(jm["lr"]), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    if moment_dtype == "int8":
        jl = jax.tree.leaves(js["m"]) + jax.tree.leaves(js["v"])
        tl = _leaves(ts["m"]) + _leaves(ts["v"])           # {'q', 's'} in key order
        for a, b in zip(jl, tl):
            if b.dtype == torch.int8:
                assert np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    else:
        rtol = 1e-6 if moment_dtype == "float32" else 2 ** -7
        for a, b in zip(jax.tree.leaves(js["m"]) + jax.tree.leaves(js["v"]),
                        _leaves(ts["m"]) + _leaves(ts["v"])):
            assert b.dtype == tadamw.MOMENT_DTYPES[moment_dtype]
            want = np.asarray(a, np.float32)
            np.testing.assert_allclose(_np(b), want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _leaves(tree):
    from repro_torch import tree as T

    return T.leaves(tree)


def test_schedule_and_clip_match_reference():
    cfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    tcfg = tadamw.AdamWConfig(**vars(cfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            _np(tadamw.schedule(tcfg, torch.tensor(step, dtype=torch.int32))),
            np.asarray(jadamw.schedule(cfg, jnp.asarray(step, jnp.int32))), rtol=1e-6)
    rng = np.random.default_rng(1)
    g = _grads(rng, _params(rng), 3.0)
    np.testing.assert_allclose(_np(tadamw.global_norm(interop.params_from_numpy(g, "cpu"))),
                               np.asarray(jadamw.global_norm(g)), rtol=1e-6)


def test_clip_bounds_the_first_step():
    """With grads of norm >> grad_clip and no decay, the first step moves
    every entry by the step's lr (Adam's first step is sign(g) lr, whatever
    the clip scales) and the reported norm is the unclipped one."""
    cfg = tadamw.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, total_steps=10)
    p = {"w": torch.zeros(10)}
    st = tadamw.init(p, cfg)
    g = {"w": torch.arange(1.0, 11.0) * 100}
    _, _, m = tadamw.update(g, st, p, cfg)
    assert float(m["grad_norm"]) == pytest.approx(float(g["w"].norm()), rel=1e-6)
    lr = float(tadamw.schedule(cfg, torch.tensor(1)))
    assert float(m["lr"]) == lr and lr < 0.1
    np.testing.assert_allclose(p["w"].numpy(), -lr * np.ones(10), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096 + 3])
def test_int8_codec_bit_equal_to_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 50.0], n)).astype(np.float32)
    x[:: 7] = 0.0
    jq, js = jadamw._q8(jnp.asarray(x))
    tq, ts = tadamw._q8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tadamw._dq8(tq, ts, (n,))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jadamw._dq8(jq, js, (n,))))
    assert np.abs(back.numpy() - x).max() <= float(ts.max()) / 2 + 1e-12


def test_int8_round_is_half_to_even():
    """0.5 and 2.5 of a scale go to 0 and 2, as jnp.round rounds."""
    x = torch.zeros(256)
    x[0], x[1], x[2] = 127.0, 0.5, 2.5        # scale 1 + 1e-12: 0.5 and 2.5 stay ties
    q, _ = tadamw._q8(x)
    assert q[0, :3].tolist() == [127, 0, 2]


# ---------------------------------------------------------------------------
# checkpoints, both directions
# ---------------------------------------------------------------------------


def _ck_numpy(rng):
    return {"p": {"a": rng.standard_normal((3, 4)).astype(np.float32),
                  "l": [rng.standard_normal((2, 2)).astype(np.float32),
                        rng.standard_normal((5,)).astype(np.float32)]},
            "o": {"step": np.asarray(9, np.int32),
                  "m": {"a": {"q": rng.integers(-127, 128, (1, 256)).astype(np.int8),
                              "s": rng.random((1, 1)).astype(np.float32)}}}}


def _jax_tree(tree, bf16):
    """The tree as JAX arrays, `bf16` paths ("p/a", "p/l/1") in bfloat16."""
    def conv(path, x):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        return jnp.asarray(x, jnp.bfloat16) if key in bf16 else jnp.asarray(x)
    return jax.tree_util.tree_map_with_path(conv, tree)


BF16 = ("p/a", "p/l/1")


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    jt = _jax_tree(_ck_numpy(rng), BF16)
    tt = interop.params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    assert tt["p"]["a"].dtype == torch.bfloat16
    path = str(tmp_path / "step_9")
    tckpt.save(path, tt, step=9, extra={"data": {"seed": 0, "step": 4}})
    man = jckpt.manifest(path)
    assert man["step"] == 9 and man["extra"]["data"]["step"] == 4
    assert man["keys"] == sorted(man["keys"])
    back = jckpt.restore(path, jt)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(jt)[0]):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64) if a.dtype == jnp.bfloat16
                                      else np.asarray(a),
                                      np.asarray(b, np.float64) if b.dtype == jnp.bfloat16
                                      else np.asarray(b))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    jt = _jax_tree(_ck_numpy(rng), BF16)
    path = str(tmp_path / "step_3")
    jckpt.save(path, jt, step=3)
    target = interop.params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    target = jax.tree.map(lambda t: torch.zeros_like(t), target)
    back = tckpt.restore(path, target)
    want = interop.params_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    for (pa, a), (pb, b) in zip(_walk(back), _walk(want)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), pa
    assert tckpt.manifest(path)["step"] == 3


def _walk(tree):
    from repro_torch import tree as T

    return [(p, leaf) for p, leaf in T.walk(tree)]


def _tree():
    return {"m": {"dist": torch.arange(8, dtype=torch.float32),
                  "rank": torch.ones((4, 2))},
            "step_count": torch.tensor(3, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "ck")
    tckpt.save(path, _tree(), step=11, extra={"graph_version": 5})
    man = tckpt.manifest(path)
    assert man["step"] == 11 and man["extra"]["graph_version"] == 5
    restored = tckpt.restore(path, _tree())
    for k in ("dist", "rank"):
        assert torch.equal(restored["m"][k], _tree()["m"][k])
    assert int(restored["step_count"]) == 3
    assert not any(d.startswith(".tmp") for d in os.listdir(str(tmp_path)))


def test_manager_rotation_and_restore_latest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(_tree()) == (None, None)
    for step in (1, 2, 3):
        t = _tree()
        t["step_count"] = torch.tensor(step, dtype=torch.int32)
        mgr.save(step, t, extra={"s": step})
    assert mgr.latest_step() == 3
    kept = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("step_"))
    assert kept == ["step_2", "step_3"]          # keep-N rotation
    restored, man = mgr.restore_latest(_tree())
    assert man["step"] == 3 and int(restored["step_count"]) == 3


def test_manager_async_save_snapshots_before_the_thread(tmp_path):
    """An async save holds the values at the call: a leaf overwritten in
    place right after (as the train loop does) does not reach the file."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=3, async_save=True)
    t = _tree()
    mgr.save(5, t)
    t["m"]["dist"].fill_(-1.0)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, man = mgr.restore_latest(_tree())
    assert man["step"] == 5 and torch.equal(restored["m"]["dist"], _tree()["m"]["dist"])


# ---------------------------------------------------------------------------
# data streams
# ---------------------------------------------------------------------------


def test_token_stream_bit_equal_to_reference_with_resume():
    a, b = jdata.TokenStream(1000, 4, 16, seed=3), tdata.TokenStream(1000, 4, 16, seed=3)
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            np.testing.assert_array_equal(x, y)
    st = b.state()
    x1, y1 = next(b)
    c = tdata.TokenStream(1000, 4, 16, seed=3)
    c.restore(st)
    x2, y2 = next(c)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    assert (y1[:, :-1] == x1[:, 1:]).all()
    with pytest.raises(AssertionError):
        tdata.TokenStream(1000, 4, 16, seed=4).restore(st)


def test_click_stream_bit_equal_to_reference_with_resume():
    a, b = jdata.ClickStream(4, 50, 8, batch=512, seed=0), tdata.ClickStream(4, 50, 8, 512, seed=0)
    for _ in range(2):
        for x, y in zip(next(a), next(b)):
            np.testing.assert_array_equal(x, y)
    c = tdata.ClickStream(4, 50, 8, 512, seed=0)
    c.restore(b.state())
    for x, y in zip(next(a), next(c)):
        np.testing.assert_array_equal(x, y)
    ids, y = next(c)
    assert ids.shape == (512, 4) and ids.dtype == np.int32 and 0.05 < y.mean() < 0.95


def test_gnn_dataset_bit_equal_to_reference():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 200, 800), rng.integers(0, 200, 800)
    for a, b in zip(jdata.gnn_dataset(200, src, dst, 16, 5, seed=2),
                    tdata.gnn_dataset(200, src, dst, 16, 5, seed=2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# fault guards
# ---------------------------------------------------------------------------


def test_watchdog_counts_stragglers(monkeypatch):
    t = iter([0.0, 1.0, 10.0, 11.0, 20.0, 30.0, 40.0, 41.0])
    monkeypatch.setattr(tfault.time, "monotonic", lambda: next(t))
    wd = tfault.StepWatchdog(straggler_factor=3.0, ema=0.9)
    flags = []
    for _ in range(4):
        wd.start()
        flags.append(wd.stop())
    assert flags == [False, False, True, False]
    s = wd.summary()
    assert s["steps"] == 4 and s["stragglers"] == 1
    assert s["ema_step_time_s"] == pytest.approx(1.0)   # the straggler does not move the EMA


def test_heartbeat_writes_atomic_json(tmp_path):
    hb_path = str(tmp_path / "hb.json")
    hb = tfault.Heartbeat(hb_path, interval_s=0.0)
    hb.beat(7, rank=3)
    with open(hb_path) as f:
        doc = json.load(f)
    assert doc["step"] == 7 and doc["rank"] == 3 and "wall" in doc
    assert not os.path.exists(hb_path + ".tmp")
    hb._last = 0.0
    hb.beat(8)
    with open(hb_path) as f:
        assert json.load(f)["step"] == 8


def test_heartbeat_respects_interval(tmp_path, monkeypatch):
    """On a clock past the interval the first beat writes and a second one
    inside the interval does not (the reference's own test reads the real
    monotonic clock, which on a machine up for less than the interval
    skips the first beat too)."""
    now = iter([1e6, 1e6 + 1.0])
    monkeypatch.setattr(tfault.time, "monotonic", lambda: next(now))
    hb = tfault.Heartbeat(str(tmp_path / "hb.json"), interval_s=9999.0)
    hb.beat(1)
    hb.beat(2)
    with open(hb.path) as f:
        assert json.load(f)["step"] == 1


def test_preemption_guard_sets_flag_and_restores():
    orig = signal.getsignal(signal.SIGTERM)
    guard = tfault.PreemptionGuard().install()
    try:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is orig


def test_skippable_iterator_skips_failed_shard():
    def make(shard):
        if shard == 1:
            raise RuntimeError("dead host")
        return iter([f"s{shard}a", f"s{shard}b"])

    it = tfault.SkippableIterator(make, n_shards=3)
    assert [next(it) for _ in range(4)] == ["s0a", "s0b", "s2a", "s2b"]
    assert it.skipped == [1]


def test_skippable_iterator_stops_when_every_shard_fails():
    def make(shard):
        raise RuntimeError("dead")

    it = tfault.SkippableIterator(make, n_shards=2)
    with pytest.raises(StopIteration):
        next(it)
    assert it.skipped == [0, 1, 0]


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------


def _graph():
    g = tgen.rmat(8, 4, seed=3, device="cpu")
    return g, g.out.row_ptr.numpy(), g.out.col_idx.numpy()


def test_sample_block_invariants():
    """Every sampled neighbour lies in its seed's adjacency, a zero-degree
    seed loops to itself, the shapes are static, and one generator seed
    gives one block."""
    g, rp, ci = _graph()
    deg = rp[1:] - rp[:-1]
    zero = np.flatnonzero(deg == 0)
    seeds = np.concatenate([np.arange(40), zero[:4]]).astype(np.int32)
    blk = tsampler.sample_block(g.out, torch.from_numpy(seeds), 5,
                                torch.Generator().manual_seed(0))
    assert blk.src_nodes.shape == (len(seeds) * 5,) and blk.src_nodes.dtype == torch.int32
    assert blk.dst_local.tolist() == np.repeat(np.arange(len(seeds)), 5).tolist()
    src = blk.src_nodes.numpy().reshape(-1, 5)
    for i, v in enumerate(seeds):
        nbrs = set(ci[rp[v]:rp[v + 1]].tolist()) or {int(v)}
        assert set(src[i].tolist()) <= nbrs
    again = tsampler.sample_block(g.out, torch.from_numpy(seeds), 5,
                                  torch.Generator().manual_seed(0))
    assert torch.equal(again.src_nodes, blk.src_nodes)


def test_multihop_shapes_match_block_shapes():
    g, _, _ = _graph()
    seeds = torch.arange(16, dtype=torch.int32)
    blocks = tsampler.sample_multihop(g.out, seeds, (3, 2), torch.Generator().manual_seed(1))
    shapes = tsampler.block_shapes(16, (3, 2))
    assert shapes == jsampler.block_shapes(16, (3, 2))
    assert [(b.seeds.shape[0], b.src_nodes.shape[0]) for b in blocks] == shapes
    assert torch.equal(blocks[1].seeds, blocks[0].src_nodes)


def test_host_sample_bit_equal_to_reference():
    _, rp, ci = _graph()
    seeds = np.arange(0, 256, 3)
    np.testing.assert_array_equal(tsampler.host_sample(rp, ci, seeds, 4, seed=7),
                                  jsampler.host_sample(rp, ci, seeds, 4, seed=7))


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "int8"])
def test_reference_opt_state_carried_by_interop(moment_dtype):
    """A reference AdamW state after one step (bf16 moments, or int8 {'q',
    's'} leaves), carried by `interop.opt_state_from_numpy`, takes the next
    update as the reference's does."""
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    cfg = jadamw.AdamWConfig(lr=0.01, moment_dtype=moment_dtype, warmup_steps=1, total_steps=4)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.init(jp, cfg)
    jp, js, _ = jadamw.update(jax.tree.map(jnp.asarray, _grads(rng, p0, 1.0)), js, jp, cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    g = _grads(rng, p0, 1.0)
    jp, js, _ = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, cfg)
    tadamw.update(interop.params_from_numpy(g, "cpu"), ts, tp, tadamw.AdamWConfig(**vars(cfg)))
    for a, b in zip(jax.tree.leaves(jp), _leaves(tp)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-7)
