"""The port's GPipe pipeline (`repro_torch.distributed.pipeline`) on CPU
meshes against the reference on the CPU.

`tests/test_pipeline.py`'s config (3 layers, d 32, 4/2 heads, Dh 8, d_ff
64, vocab 128, no remat, aux 0) and M = 4 micro-batches of (2, 16) tokens,
drawn from a numpy seed; the reference's initial weights carried by
`interop.params_from_numpy`. Held against `jax.value_and_grad` of
`repro.models.transformer.loss_fn` on the same 8 x 16 tokens at that
test's tolerances (loss within 5e-3, each gradient within 2 % of its
largest entry: the bf16 stash of every stage's input moves them), and with
one stage against the reference's own `pipeline_loss_and_grads` on a (1, 1)
jax mesh, whose stash rounds the same values: loss within 1e-5, gradients
within 1e-4 of their largest entry. Padding layers get exactly zero
gradients, and a repeat is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import AxisType, make_mesh
from repro.distributed import pipeline as jpp
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch import mesh as M
from repro_torch.distributed import pipeline as pp
from repro_torch.models import transformer as ttf

CFG = dict(name="t", n_layers=3, d_model=32, n_heads=4, n_kv=2, d_ff=64, vocab=128,
           head_dim=8, remat=False, aux_loss_weight=0.0)
MESHES = [(2, 2), (1, 2), (4, 1)]
LOSS_ERR, GRAD_ERR = 5e-3, 0.02           # tests/test_pipeline.py
ONE_STAGE_LOSS_ERR, ONE_STAGE_GRAD_ERR = 1e-5, 1e-4


def reference_case(pipeline_fn):
    """(cfg, port cfg, params, tokens, labels, value_and_grad of loss_fn,
    the reference pipeline's (loss, grads) with one stage on a (1, 1) jax
    mesh), numpy throughout."""
    cfg = jtf.TransformerConfig(**CFG)
    params = jtf.init_params(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 2, 16)).astype(np.int32)
    lbls = rng.integers(0, cfg.vocab, (4, 2, 16)).astype(np.int32)
    loss, grads = jax.jit(jax.value_and_grad(jtf.loss_fn), static_argnums=3)(
        params, jnp.asarray(toks.reshape(8, 16)), jnp.asarray(lbls.reshape(8, 16)), cfg)
    mesh = make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    pc = jpp.plan(cfg, 1, 4)
    with jsh.activate(mesh):
        one = jax.jit(lambda p, t, l: pipeline_fn(p, t, l, cfg, pc, mesh))(
            params, jnp.asarray(toks), jnp.asarray(lbls))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return (cfg, ttf.TransformerConfig(**CFG), to_np(params), toks, lbls,
            (float(loss), to_np(grads)), (float(one[0]), to_np(one[1])))


@pytest.fixture(scope="module")
def case():
    return reference_case(jpp.pipeline_loss_and_grads)


def run_port(fn, case, shape):
    _, tcfg, params, toks, lbls, _, _ = case
    mesh = M.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    pc = pp.plan(tcfg, shape[0], 4)
    tparams = interop.params_from_numpy(params, "cpu")
    tparams = dict(tparams, layers=pp.pad_layer_stack(tparams["layers"], tcfg, pc))
    return fn(tparams, torch.from_numpy(toks), torch.from_numpy(lbls), tcfg, pc, mesh)


def assert_close(got, want, n_layers, loss_err, grad_err, what):
    loss, grads = got
    want_loss, want_grads = want
    assert abs(float(loss) - want_loss) < loss_err, (what, float(loss), want_loss)
    for k, b in want_grads["layers"].items():
        a = grads["layers"][k][:n_layers].numpy()
        scale = max(float(np.abs(b).max()), 1e-3)
        assert float(np.abs(a - b).max()) < grad_err * scale, (what, k)
    for k in ("embed", "lm_head", "final_norm"):
        a, b = grads[k].numpy(), want_grads[k]
        assert a.shape == b.shape and a.dtype == np.float32
        scale = max(float(np.abs(b).max()), 1e-3)
        assert float(np.abs(a - b).max()) < grad_err * scale, (what, k)


def assert_padding_zero(grads, n_layers):
    for k, g in grads["layers"].items():
        pad = g[n_layers:]
        if pad.numel():
            assert float(pad.abs().max()) == 0.0, k


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_matches_value_and_grad(case, shape):
    got = run_port(pp.pipeline_loss_and_grads, case, shape)
    assert_close(got, case[5], case[0].n_layers, LOSS_ERR, GRAD_ERR, shape)
    assert_padding_zero(got[1], case[0].n_layers)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_pipeline_one_stage_matches_the_reference_pipeline(case, shape):
    got = run_port(pp.pipeline_loss_and_grads, case, shape)
    assert_close(got, case[6], case[0].n_layers, ONE_STAGE_LOSS_ERR, ONE_STAGE_GRAD_ERR, shape)


def test_pipeline_repeats_bit_equal(case):
    a = run_port(pp.pipeline_loss_and_grads, case, (4, 1))
    b = run_port(pp.pipeline_loss_and_grads, case, (4, 1))
    assert torch.equal(a[0], b[0])
    for k in a[1]["layers"]:
        assert torch.equal(a[1]["layers"][k], b[1]["layers"][k]), k
    for k in ("embed", "lm_head", "final_norm"):
        assert torch.equal(a[1][k], b[1][k]), k


def test_plan_and_identity_padding():
    cfg = ttf.TransformerConfig(**CFG)
    pc = pp.plan(cfg, 2, 4)
    assert (pc.layers_per_stage, pp.padded_layers(cfg, pc)) == (2, 4)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    padded = pp.pad_layer_stack(params["layers"], cfg, pc)
    x = torch.randn(2, 16, cfg.d_model)
    pos = torch.arange(16).expand(2, 16)
    last = {k: v[3] for k, v in padded.items()}
    assert torch.equal(ttf._layer(cfg, x, last, pos)[0], x)     # residual passthrough
    assert pp.pad_layer_stack(params["layers"], cfg, pp.plan(cfg, 1, 4)).keys() == \
        params["layers"].keys()
    ref = jpp.param_logical_axes_pp(jtf.TransformerConfig(**CFG))
    assert pp.param_logical_axes_pp(cfg) == ref
