"""The port's dry-run (`repro_torch.launch.dryrun`, `cost`, `mesh`, `analytic`)
against the reference's on the CPU.

* Per-device argument bytes of all 40 cells on both production meshes equal
  exactly what the reference's own builders, `RULES` and `spec` give under
  `jax.sharding.AbstractMesh` of the same shapes (its `shard_shape`).
* `analytic.lm_cell` equals the reference's for every LM cell and mesh.
* Counted flops of an unrolled tiny LM train step fall within the
  reference's 35 % of the analytic model (its
  `test_roofline_correction.py` calibration, on counts that need no
  correction: eager runs have no scan).
* The roofline math on `H100` and the collective counter.
* Every kernel's meta route gives its plain version's shapes and dtypes.
* Full-size cells on meta: `OK` for deepfm/serve_p99 and
  gcn-cora/full_graph_sm, `SKIP` for granite-3-8b/long_500k.
"""

import contextlib
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as jconfigs
from repro.distributed import sharding as jsh
from repro.launch import analytic as janalytic
from repro.launch import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch import mesh as M
from repro_torch.kernels import embedding_bag as tbag
from repro_torch.kernels import ell_spmv as tell
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import frontier_pack as tfp
from repro_torch.kernels import ops
from repro_torch.kernels import segment_reduce as tsr
from repro_torch.kernels.tuning import H100
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import cost, dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def _abstract_mesh(mesh):
    """The reference's `sh.activate` without `with mesh:`, which an
    AbstractMesh refuses; its `spec` reads only the active list."""
    jsh._ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        jsh._ACTIVE.pop()


def _shard_bytes(tree, shardings) -> int:
    """Per-device bytes of a tree of ShapeDtypeStructs under a tree of
    NamedShardings that may be a prefix of it (None: replicated)."""
    if isinstance(shardings, NamedSharding) or shardings is None:
        total = 0
        for leaf in jax.tree.leaves(tree):
            shape = leaf.shape if shardings is None else shardings.shard_shape(leaf.shape)
            total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
        return total
    if isinstance(shardings, dict):
        return sum(_shard_bytes(tree[k], v) for k, v in shardings.items())
    return sum(_shard_bytes(t, s) for t, s in zip(tree, shardings))


def _reference_argument_bytes(arch, shape, multi_pod, monkeypatch):
    shape_t, axes = MESHES[multi_pod]
    mesh = AbstractMesh(shape_t, axes)
    monkeypatch.setattr(jsh, "activate", _abstract_mesh)
    built = jsteps.build(jconfigs.get(arch), shape, mesh)
    if built.skip:
        return None
    return _shard_bytes(built.abstract_inputs, built.in_shardings)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", tconfigs.cells(), ids=lambda c: str(c))
def test_argument_bytes_equal_the_reference_shard_shapes(arch, shape, multi_pod, monkeypatch):
    want = _reference_argument_bytes(arch, shape, multi_pod, monkeypatch)
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    built = tsteps.build(tconfigs.get(arch), shape, mesh)
    assert built.skip == (want is None)
    if want is None:
        return
    got = dryrun.per_device_bytes(built.abstract_inputs, built.in_shardings, mesh)
    assert got == want


def test_argument_alloc_bytes_round_each_block_to_the_allocators_unit():
    """`argument_alloc_bytes` is `argument_bytes` with each tensor's block
    rounded up to 512 bytes, as PyTorch's caching allocator hands them out;
    a leaf that is not a tensor holds none, a host scalar none on the
    device."""
    mesh = tmesh.make_production_mesh(multi_pod=False)
    meta = lambda *shape: torch.empty(shape, device="meta")       # noqa: E731
    tree = {"one": meta(1), "row": meta(128), "row1": meta(129), "cols": meta(16, 3), "n": 7,
            "seed": torch.tensor(3, dtype=torch.int32)}
    specs = {"one": None, "row": None, "row1": None, "cols": ("model", None), "n": None,
             "seed": None}
    assert dryrun.per_device_bytes(tree, specs, mesh) == 4 + 512 + 516 + 12 + 4
    # the host scalar takes no device memory
    assert dryrun.per_device_bytes(dryrun.on_device(tree), specs, mesh,
                                   dryrun.ALLOC_ROUND) == 512 * 5
    assert dryrun.per_device_bytes(meta(0), None, mesh, dryrun.ALLOC_ROUND) == 0


@pytest.mark.parametrize("arch", [a for a in tconfigs.names()
                                  if tconfigs.get(a).family == "lm"])
def test_analytic_equals_the_reference(arch):
    jcfg, tcfg = jconfigs.get(arch).make_config(), tconfigs.get(arch).make_config()
    for shape, sh in tconfigs.get(arch).shapes.items():
        for multi_pod in (False, True):
            shape_t, axes = MESHES[multi_pod]
            ext = dict(zip(axes, shape_t))
            dp, tp = ext["data"] * ext.get("pod", 1), ext["model"]
            kind = "train" if sh["kind"] == "train" else sh["kind"]
            accum = max(1, min(16, sh["batch"] // dp))
            for mb in (4, 2):
                want = janalytic.lm_cell(jcfg, kind, sh["batch"], sh["seq"], dp, tp,
                                         accum=accum, moment_bytes=mb)
                got = tanalytic.lm_cell(tcfg, kind, sh["batch"], sh["seq"], dp, tp,
                                        accum=accum, moment_bytes=mb)
                assert got.flops_global == want.flops_global
                assert got.bytes_per_device == want.bytes_per_device
                assert got.detail == want.detail


def test_builders_carry_the_reference_analytic_and_model_flops(monkeypatch):
    """The LM builders' `analytic` dicts and every builder's `model_flops`
    equal the reference builders' on both production meshes."""
    for arch, shape in tconfigs.cells():
        for multi_pod in (False, True):
            shape_t, axes = MESHES[multi_pod]
            monkeypatch.setattr(jsh, "activate", _abstract_mesh)
            want = jsteps.build(jconfigs.get(arch), shape, AbstractMesh(shape_t, axes))
            got = tsteps.build(tconfigs.get(arch), shape,
                               tmesh.make_production_mesh(multi_pod=multi_pod))
            assert got.model_flops == pytest.approx(want.model_flops, rel=1e-12)
            assert got.analytic == want.analytic
            assert (got.kind, got.skip, got.donate_argnums) == (
                want.kind, want.skip, want.donate_argnums)


def test_counted_flops_within_the_reference_calibration():
    """The reference's calibration config, an unrolled train step (no
    remat, the layers in a Python loop as the port always runs them): the
    counted flops of forward + backward within 35 % of the analytic
    matmul + attention flops."""
    cfg = dataclasses.replace(
        tconfigs.get("granite-3-8b").make_reduced(), name="cal", n_layers=2, d_model=128,
        n_heads=4, n_kv=2, d_ff=256, vocab=2048, head_dim=32, remat=False)
    from repro_torch.models import transformer as tfm
    from repro_torch import tree as T

    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    leaves = [t.requires_grad_() for t in T.leaves(params)]
    toks = torch.zeros((2, 64), dtype=torch.int64, device="meta")
    with cost.counting(params, toks) as c:
        torch.autograd.grad(tfm.loss_fn(params, toks, toks, cfg), leaves)
    ana = tanalytic.lm_cell(cfg, "train", batch=2, seq=64, dp=1, tp=1, accum=1)
    want = ana.detail["flops_mm"] + ana.detail["flops_attn"]
    assert c.flops == pytest.approx(want, rel=0.35)
    # the flash kernels both ways; segment_reduce in the embedding's scatter
    assert set(c.kernels) == {"flash_attention_f32", "flash_attention_bwd", "segment_reduce"}


def test_scan_free_counts_scale_with_trips():
    """Eager loops are counted trip by trip: 8 chained products count 8
    times one (the reference's scan body counted once has no
    counterpart)."""
    x = torch.empty((128, 128), device="meta")
    w = torch.empty((8, 128, 128), device="meta")
    with cost.counting() as one:
        x @ w[0]
    with cost.counting() as eight:
        y = x
        for i in range(8):
            y = y @ w[i]
    assert eight.flops == 8 * one.flops == 8 * 2 * 128 ** 3


def test_roofline_terms_math():
    rec = {
        "flops": 989e12,          # half a second of bf16 compute on each of 2 chips
        "bytes_accessed": 2 * 3.35e12,          # one second of HBM on each
        "collectives": {"wire_bytes": 225e9},     # half a second of NVLink
        "chips": 2,
        "model_flops": 2 * 989e12,
        "compute_dtype": "bfloat16",
    }
    r = dryrun.roofline_terms(rec)
    assert r["compute_s"] == pytest.approx(0.5)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["collective_s"] == pytest.approx(0.5)
    assert r["dominant"] == "memory" and r["split"] == "even"
    assert r["model_flops_ratio"] == pytest.approx(2.0)
    assert r["roofline_frac"] == pytest.approx(1.0)
    # analytic cells take compute and memory from the model; float32 cells
    # run at the CUDA cores' rate; no collectives: the term is skipped
    rec = {"analytic": {"flops_global": 2 * 67e12, "bytes_per_device": 3.35e12},
           "collectives": None, "chips": 2, "model_flops": 0.0, "compute_dtype": "float32"}
    r = dryrun.roofline_terms(rec)
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == (pytest.approx(1.0),
                                                                  pytest.approx(1.0), None)
    assert r["split"] == "analytic" and r["peak_flops"] == H100.f32_flops
    assert r["roofline_frac"] is None


def test_collectives_count_each_trip():
    """A `reduce_to` in a 6-trip loop on a ["cpu"] * 2 mesh counts 6
    all-reduces of one shard's operand; a one-shard fold counts none."""
    mesh = M.make_mesh(2, 1, devices=["cpu"] * 2)
    parts = [torch.ones((8, 128)) for _ in range(mesh.shape["data"])]
    with cost.counting() as c:
        for _ in range(6):
            total = M.reduce_to(parts, "sum")
            parts = [p + total for p in parts]
        M.reduce_to(parts[:1], "sum")
    rec = c.collectives()
    assert rec["counts"]["all-reduce"] == 6
    assert rec["bytes"]["all-reduce"] == 6 * 8 * 128 * 4
    assert rec["wire_bytes"] == 2.0 * 6 * 8 * 128 * 4


def test_pipeline_sends_and_tp_gathers_are_counted():
    """The fill-drain schedule's stage-to-stage sends (forward and
    backward) and the TP gather of the stash, on a (2, 2) mesh of the
    CPU."""
    from repro_torch.distributed import pipeline as pp
    from repro_torch.distributed import pipeline_tp as pptp
    from repro_torch.models import transformer as tfm

    cfg = tconfigs.get("granite-3-8b").make_reduced()
    mesh = M.make_mesh(2, 2, devices=["cpu"] * 4)
    pc = pp.plan(cfg, 2, 3)
    p = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = dict(p, layers=pp.pad_layer_stack(p["layers"], cfg, pc))
    toks = torch.randint(0, cfg.vocab, (3, 1, 8), generator=torch.Generator().manual_seed(1))
    with cost.counting() as c:
        pptp.pipeline_tp_loss_and_grads(p, toks, toks, cfg, pc, mesh)
    rec = c.collectives()
    # 3 micros cross one stage boundary forward and back
    assert rec["counts"]["collective-permute"] == 6
    assert rec["bytes"]["collective-permute"] == 6 * 8 * cfg.d_model * 4
    # each stage's backward tick gathers its 2 stashed seq slices back, and
    # joins their 2 gradients, once a micro
    assert rec["counts"]["all-gather"] == 12
    assert rec["counts"]["all-reduce"] > 0


# ---------------------------------------------------------------------------
# meta routes
# ---------------------------------------------------------------------------


def _meta(t):
    return t.to("meta")


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.device.type == "meta" and (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)


def _slice(rng, r=6, w=5, n=9):
    nbr = torch.from_numpy(rng.integers(0, n + 1, (r, w)).astype(np.int32))
    wgt = torch.from_numpy(rng.random((r, w)).astype(np.float32))
    return nbr, wgt, n


def _cases():
    rng = np.random.default_rng(0)
    nbr, wgt, n = _slice(rng)
    vals = torch.rand(n + 1)
    ids = torch.sort(torch.from_numpy(rng.integers(0, 7, 20).astype(np.int32))).values
    q = torch.randn(2, 4, 5, 16)
    k, v = torch.randn(2, 2, 7, 16), torch.randn(2, 2, 7, 16)
    out = tfa.attention_plain(q, k, v, True)
    lse = torch.zeros(2, 4, 5)
    return [
        ("ell_combine", tell.ell_combine_plain, tell.ell_combine_meta,
         (nbr, wgt, vals, "add_w", "min")),
        ("ell_combine_overlay", tell.ell_combine_plain, tell.ell_combine_meta,
         (nbr, wgt, vals, "copy", "sum", nbr > 3)),
        ("ell_combine_batched", tell.ell_combine_batched_plain, tell.ell_combine_batched_meta,
         (nbr, wgt, torch.rand(n + 1, 3), "copy", "sum")),
        ("ell_spmm", tell.ell_spmm_plain, tell.ell_spmm_meta, (nbr, wgt, torch.rand(n + 1, 4))),
        ("frontier_pack", tfp.frontier_pack_plain, tfp.frontier_pack_meta,
         (torch.rand(40) < 0.5, 16)),
        ("segment_reduce", tsr.segment_reduce_plain, tsr.segment_reduce_meta,
         (torch.rand(20, 3), ids, 9, "max", None)),
        ("embedding_bag", tbag.embedding_bag_plain, tbag.embedding_bag_meta,
         (torch.rand(11, 4), torch.from_numpy(rng.integers(0, 11, (5, 3)).astype(np.int32)),
          "mean")),
        ("flash_attention_f32", tfa.attention_plain, tfa.flash_attention_meta, (q, k, v, True)),
        ("flash_attention", tfa.attention_plain, tfa.flash_attention_meta,
         (q.bfloat16(), k.bfloat16(), v.bfloat16(), False)),
        ("flash_attention_bwd", lambda *a: tfa.attention_bwd_plain(*a[:6]),
         tfa.flash_attention_bwd_meta, (q, k, v, out, out, True, lse)),
    ]


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_meta_route_gives_the_plain_shapes(case):
    name, plain, meta, args = case
    want = plain(*args)
    margs = tuple(_meta(a) if isinstance(a, torch.Tensor) else a for a in args)
    with cost.counting() as c:
        got = meta(*margs)
    _same(got, want)
    assert c.kernels[name]["calls"] == 1 and c.kernels[name]["bytes"] > 0


#: every kernel's three routes in `kernels.ops`: (module, plain, CUDA, meta)
_ROUTES = [
    (tell, "ell_combine_plain", "ell_combine_cuda", "ell_combine_meta"),
    (tell, "ell_combine_batched_plain", "ell_combine_batched_cuda", "ell_combine_batched_meta"),
    (tell, "ell_spmm_plain", "ell_spmm_cuda", "ell_spmm_meta"),
    (tfp, "frontier_pack_plain", "frontier_pack_cuda", "frontier_pack_meta"),
    (tsr, "segment_reduce_plain", "segment_reduce_cuda", "segment_reduce_meta"),
    (tbag, "embedding_bag_plain", "embedding_bag_cuda", "embedding_bag_meta"),
    (tfa, "attention_plain", "flash_attention_cuda", "flash_attention_meta"),
    (tfa, "attention_bwd_plain", "flash_attention_bwd_cuda", "flash_attention_bwd_meta"),
]


def test_meta_lse_and_routes_are_those_of_the_cuda_wrappers():
    q = torch.empty((1, 2, 3, 8), device="meta")
    out, lse = tfa.flash_attention_meta(q, q[:, :1], q[:, :1], True, with_lse=True)
    assert (tuple(lse.shape), lse.dtype) == ((1, 2, 3), torch.float32)
    for mod, plain, cuda, meta in _ROUTES:
        for name in (plain, cuda, meta):
            assert callable(getattr(mod, name)), name


def test_autograd_ops_run_forward_and_backward_on_meta():
    """The differentiable ops take their meta routes both ways; the
    attention forward keeps the lse when a gradient will follow."""
    table = torch.empty((11, 4), device="meta", requires_grad=True)
    idx = torch.zeros((5, 3), dtype=torch.int32, device="meta")
    q = torch.empty((1, 2, 6, 8), device="meta", requires_grad=True)
    kv = torch.empty((1, 1, 6, 8), device="meta", requires_grad=True)
    vals = torch.empty((7, 2), device="meta", requires_grad=True)
    seg = torch.zeros((7,), dtype=torch.int32, device="meta")
    with cost.counting() as c:
        loss = (ops.embedding_bag(table, idx, "max").sum() + ops.attention(q, kv, kv).sum()
                + ops.segment_reduce(vals, seg, 3, "min").sum()
                + ops.gather_rows(table, idx.long()).sum())
        grads = torch.autograd.grad(loss, [table, q, kv, vals])
    assert [tuple(g.shape) for g in grads] == [(11, 4), (1, 2, 6, 8), (1, 1, 6, 8), (7, 2)]
    assert c.kernels["flash_attention_bwd"]["calls"] == 1
    assert c.kernels["segment_reduce"]["calls"] >= 3


def test_meta_is_taken_only_where_named():
    """`meta` is a device the caller names; a meta route refuses any other
    tensor, a CPU tensor never takes it, and another device has no route."""
    from repro_torch._device import resolve_device

    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError):
        tsr.segment_reduce_meta(torch.rand(3), torch.zeros(3, dtype=torch.int32), 2)
    with cost.counting() as c:
        ops.segment_reduce(torch.rand(3), torch.zeros(3, dtype=torch.int32), 2)
    assert c.kernels == {}
    with pytest.raises(ValueError):
        ops._route(_OtherDevice())


class _OtherDevice:
    device = torch.device("xpu")


# ---------------------------------------------------------------------------
# full-size cells on meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape,status", [("deepfm", "serve_p99", "OK"),
                                               ("gcn-cora", "full_graph_sm", "OK"),
                                               ("granite-3-8b", "long_500k", "SKIP")])
def test_full_size_cells_on_meta(arch, shape, status, multi_pod, tmp_path):
    rec = dryrun.run_cell(arch, shape, multi_pod)
    assert rec["status"] == status, rec.get("traceback")
    assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
    json.dumps(rec)
    if status == "SKIP":
        assert "sub-quadratic" in rec["skip_reason"]
        return
    mem = rec["memory"]
    assert mem["temp_bytes"] is None and mem["temp_reason"]
    assert rec["collectives"] is None and rec["roofline"]["collective_s"] is None
    assert 0 < mem["argument_bytes"] <= mem["one_device_peak_bytes"]
    assert mem["argument_bytes"] <= mem["argument_alloc_bytes"] < mem["argument_bytes"] + 512 * 4096
    # serving donates nothing; a train step donates its params and moments
    assert (mem["alias_bytes"] > 0) == (arch != "deepfm")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    kernel = "embedding_bag" if arch == "deepfm" else "segment_reduce"
    assert rec["kernels"][kernel]["calls"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory")


def test_cli_writes_the_records(tmp_path, capsys):
    out = tmp_path / "dr.jsonl"
    rc = dryrun.main(["--arch", "deepfm", "--shape", "serve_p99", "--mesh", "both",
                      "--out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert "2 records {'OK': 2, 'SKIP': 0, 'FAIL': 0}" in capsys.readouterr().out
    from repro_torch.launch import roofline

    rows = roofline.main(str(out))
    assert len(rows) == 2
