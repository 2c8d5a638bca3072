"""Split-KV decode attention (`repro_torch.nn.decode_attn`) on CPU meshes
against the reference's `decode_attention_splitkv` on a (1, 1) jax mesh
and against the unsharded decode (`nn.layers._decode_attention`), float32
within 1e-5; and the `attn_override` hook through `decode_step`."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compat import AxisType, make_mesh
from repro.launch.train import tiny_config as jtiny
from repro.models import transformer as jtf
from repro.nn import decode_attn as jda
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch import mesh as M
from repro_torch.launch.train import tiny_config as ttiny
from repro_torch.models import transformer as ttf
from repro_torch.nn import decode_attn as tda
from repro_torch.nn import layers as TL

ERR = 1e-5
B, H, HKV, S, DH = 3, 8, 2, 64, 16


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, 1, DH), (B, HKV, S, DH), (B, HKV, S, DH)))


@pytest.fixture(scope="module")
def jax_mesh():
    return make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.fixture(scope="module")
def reference(qkv, jax_mesh):
    """valid_len -> the reference's split-KV output (each computed once)."""
    fn = jax.jit(lambda q, k, v, n: jda.decode_attention_splitkv(q, k, v, n, jax_mesh))
    return functools.lru_cache(None)(
        lambda n: np.asarray(fn(*map(jnp.asarray, qkv), jnp.int32(n))))


# valid lengths: ending inside a shard of 2 and of 4 (37), the whole cache,
# inside the first of 4 shards (5); meshes: 1, 2, 4 'model' shards, and a
# batch of 3 that divides 'data' 3 and does not divide 'data' 2
@pytest.mark.parametrize("valid_len", [37, 64, 5])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (1, 4), (2, 4), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_splitkv_matches_the_reference_and_the_unsharded_decode(qkv, reference, shape,
                                                                valid_len):
    want = reference(valid_len)
    mesh = M.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    tq, tk, tv = (torch.from_numpy(x) for x in qkv)
    got = tda.decode_attention_splitkv(tq, tk, tv, valid_len, mesh)
    assert got.shape == (B, H, 1, DH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=ERR, atol=ERR)
    plain = TL._decode_attention(tq, tk, tv, valid_len)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=ERR, atol=ERR)


def test_splitkv_bf16_follows_the_reference_dtypes(qkv, jax_mesh):
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, qkv))
    want = np.asarray(jda.decode_attention_splitkv(q, k, v, jnp.int32(50), jax_mesh)
                      .astype(jnp.float32))
    mesh = M.make_mesh(1, 4, devices=["cpu"] * 4)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv)
    got = tda.decode_attention_splitkv(tq, tk, tv, 50, mesh)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


def test_decode_step_with_the_override_equals_without():
    """A tiny granite-3-8b with the reference's weights: a 12-token prefill,
    then three decode steps, each through `decode_step` with the split-KV
    override on a (1, 4) mesh and without it: logits and caches within
    1e-5 (layer 0's cache rows equal); the reference's decode_step with its own override on a (1, 1)
    jax mesh gives the same logits."""
    cfg = jtiny(jconfigs.get("granite-3-8b").make_config())
    tcfg = ttiny(tconfigs.get("granite-3-8b").make_config())
    params = jtf.init_params(jax.random.key(0), cfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    mesh = M.make_mesh(1, 4, devices=["cpu"] * 4)
    override = functools.partial(tda.decode_attention_splitkv, mesh=mesh)
    jmesh = make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    joverride = functools.partial(jda.decode_attention_splitkv, mesh=jmesh)
    cache = ttf.init_cache(tcfg, 2, 32, device="cpu")
    jcache = jtf.init_cache(cfg, 2, 32)
    logits, cache = ttf.decode_step(tp, cache, torch.from_numpy(prompt), tcfg)
    jlogits, jcache = jtf.decode_step(params, jcache, jnp.asarray(prompt), cfg)
    for _ in range(3):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        with_o, c_o = ttf.decode_step(tp, cache, tok, tcfg, attn_override=override)
        plain, c_p = ttf.decode_step(tp, cache, tok, tcfg)
        np.testing.assert_allclose(with_o.numpy(), plain.numpy(), rtol=ERR, atol=ERR)
        assert c_o["len"] == c_p["len"]
        for key in ("k", "v"):     # layer 0's rows are equal, later ones within rounding
            assert torch.equal(c_o[key][0], c_p[key][0])
            np.testing.assert_allclose(c_o[key].numpy(), c_p[key].numpy(), rtol=ERR, atol=ERR)
        jl, jcache = jtf.decode_step(params, jcache, jnp.asarray(tok.numpy()), cfg,
                                     attn_override=joverride)
        np.testing.assert_allclose(with_o.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        logits, cache = with_o, c_o


def test_cache_logical_axes_match_the_reference():
    assert ttf.cache_logical_axes() == jtf.cache_logical_axes()
