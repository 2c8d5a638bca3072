"""The port's attention (`repro_torch.kernels.flash_attention`,
`repro_torch.nn`) against the JAX reference on the same numpy inputs: the
plain attention (the flash kernel's CPU route) against the Pallas flash
kernel in interpret mode and `ref.attention_ref`, `chunked_attention`
against JAX's, and the transformer layers — `gqa_attention` at the
reduced-dense width with the reference's own initial weights carried over
by `interop.attn_params_from_numpy`.

Tolerances: 2e-4 for float32 attention (the reference's own flash-vs-ref
bound), 2e-5 for the float32 layers (rotary angles through another pow/sin,
then matmuls in another order), 5e-2 wherever bfloat16 rounds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import _reduced_dense
from repro.kernels import flash_attention as jfa
from repro.kernels import ref
from repro.models import transformer as jtf
from repro.nn import chunked_attn as jchunk
from repro.nn import layers as JL
from repro_torch import interop
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.nn import chunked_attn as tchunk
from repro_torch.nn import layers as TL

ATTN_SHAPES = [
    (1, 2, 2, 32, 32, 16),     # MHA square
    (2, 4, 2, 64, 64, 32),     # GQA
    (1, 8, 1, 32, 32, 64),     # MQA
    (2, 4, 2, 16, 64, 32),     # decode-ish (q shorter than kv)
]


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, dtype=np.float32)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_flash_and_ref(b, hq, hkv, sq, skv, d, causal):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, sq * d + hq)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    flash = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=16, block_kv=16,
                                interpret=True)
    oracle = ref.attention_ref(jq, jk, jv, causal=causal)
    t = ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert t.shape == q.shape and t.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(flash), t.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(oracle), t.numpy(), rtol=2e-4, atol=2e-4)


def test_plain_attention_bf16():
    q, k, v = _qkv(1, 4, 2, 32, 32, 32, 9)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    flash = jfa.flash_attention(jq, jk, jv, block_q=16, block_kv=16, interpret=True)
    oracle = ref.attention_ref(jq, jk, jv)
    tq, tk, tv = (interop.tensor_from_numpy(np.asarray(x), "cpu") for x in (jq, jk, jv))
    t = tfa.attention_plain(tq, tk, tv)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(flash), _f32(t), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_f32(oracle), _f32(t), rtol=5e-2, atol=5e-2)


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [(1, 4, 2, 128, 400, 128), (1, 2, 1, 64, 512, 64),
                                               (1, 2, 1, 48, 48, 32), (2, 4, 2, 16, 48, 24)])
@pytest.mark.parametrize("causal", [True, False])
def test_rounded_attention_tracks_the_flash_kernel(b, hq, hkv, sq, skv, d, causal):
    """`attention_rounded` rounds where the Pallas kernel rounds: within
    2e-4 of it in float32, within ROUNDED_REL_ERR in bfloat16 relative norm,
    while dropping key 0 from every row moves it by more than twice that."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, skv + d)
    f32 = tfa.attention_rounded(*map(torch.from_numpy, (q, k, v)), causal)
    flash = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=16,
                                block_kv=16, interpret=True)
    np.testing.assert_allclose(np.asarray(flash), f32.numpy(), rtol=2e-4, atol=2e-4)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    flash = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=16, block_kv=16,
                                interpret=True)
    tq, tk, tv = (interop.tensor_from_numpy(np.asarray(x), "cpu") for x in (jq, jk, jv))
    r = tfa.attention_rounded(tq, tk, tv, causal)
    assert r.dtype == torch.bfloat16
    assert _rel(flash, r) <= tfa.ROUNDED_REL_ERR
    lo = 1 if causal and sq == skv else 0          # else row 0 would see no key
    dropped = tfa.attention_rounded(tq[:, :, lo:], tk[:, :, 1:], tv[:, :, 1:], causal)
    assert _rel(dropped, r[:, :, lo:]) > 2 * tfa.ROUNDED_REL_ERR


def test_plain_attention_is_group_major():
    """Query head h reads kv head h % Hkv (not h // group)."""
    q, k, v = _qkv(1, 4, 2, 8, 8, 16, 2)
    t = tfa.attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False)
    for h in range(4):
        one = tfa.attention_plain(torch.from_numpy(q[:, h:h + 1]),
                                  torch.from_numpy(k[:, h % 2:h % 2 + 1]),
                                  torch.from_numpy(v[:, h % 2:h % 2 + 1]), causal=False)
        np.testing.assert_allclose(t[:, h:h + 1].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sq,skv,qc,kc,offset,causal", [
    (128, 128, 32, 64, 0, True), (128, 128, 64, 32, 0, False),
    (32, 128, 16, 32, 96, True)])
def test_chunked_attention_matches_jax(sq, skv, qc, kc, offset, causal):
    q, k, v = _qkv(2, 4, 2, sq, skv, 16, sq + kc)
    j = jchunk.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, q_chunk=qc, kv_chunk=kc, kv_offset=offset)
    t = tchunk.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                 q_chunk=qc, kv_chunk=kc, kv_offset=offset)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=1e-5, atol=1e-5)
    if offset == skv - sq:         # the decode alignment equals the plain attention
        p = tfa.attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal)
        np.testing.assert_allclose(p.numpy(), t.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# layers at the reduced-dense width (lm_archs.py:19)
# ---------------------------------------------------------------------------


def _layer0(dtype="float32"):
    cfg = dataclasses.replace(_reduced_dense(), dtype=dtype)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    jp = {k: v[0] for k, v in params["layers"].items()}
    tp = interop.attn_params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return cfg, jp, tp


def _x(cfg, b, s, seed, dtype):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32), dtype)
    return x, interop.tensor_from_numpy(np.asarray(x), "cpu")


def _positions(b, s, start=0):
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("use_flash", [True, False])
def test_gqa_attention_matches_jax(dtype, tol, use_flash):
    cfg, jp, tp = _layer0(dtype)
    assert tp["wq"].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    b, s = 2, 16
    jx, tx = _x(cfg, b, s, 1, jnp.dtype(dtype))
    jpos, tpos = _positions(b, s)
    jh = JL.rms_norm(jx, jp["attn_norm"])
    th = TL.rms_norm(tx, tp["attn_norm"])
    np.testing.assert_allclose(_f32(jh), _f32(th), rtol=tol, atol=tol)
    jo, (jk, jv) = JL.gqa_attention(jh, jp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    positions=jpos, use_flash=use_flash, constrain=False)
    to, (tk, tv) = TL.gqa_attention(th, tp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    positions=tpos, use_flash=use_flash)
    assert to.dtype == th.dtype and to.shape == (b, s, cfg.d_model)
    for a, t in ((jo, to), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(_f32(a), _f32(t), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,cache_len", [(1, 5), (4, 9), (3, 30)])
def test_gqa_attention_kv_cache_decode_matches_jax(s, cache_len):
    cfg, jp, tp = _layer0()
    b, total = 2, 32
    rng = np.random.default_rng(s)
    shape = (b, cfg.n_kv, total, cfg.dh)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    jx, tx = _x(cfg, b, s, 2, jnp.float32)
    jpos, tpos = _positions(b, s, cache_len)
    jo, (jk, jv) = JL.gqa_attention(jx, jp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    positions=jpos, kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                                    cache_len=jnp.int32(cache_len), constrain=False)
    to, (tk, tv) = TL.gqa_attention(tx, tp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                                    positions=tpos, kv_cache=(torch.from_numpy(ck),
                                                              torch.from_numpy(cv)),
                                    cache_len=cache_len)
    for a, t in ((jo, to), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(_f32(a), _f32(t), rtol=2e-5, atol=2e-5)
    start = min(cache_len, total - s)          # clamped, as dynamic_update_slice
    assert np.array_equal(tk.numpy()[:, :, :start], ck[:, :, :start])


def test_gqa_attention_long_sequence_takes_the_chunked_path():
    cfg, jp, tp = _layer0()
    b, s = 1, TL.CHUNKED_FROM
    jx, tx = _x(cfg, b, s, 3, jnp.float32)
    jpos, tpos = _positions(b, s)
    jo, _ = JL.gqa_attention(jx, jp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                             positions=jpos, use_flash=True, constrain=False)
    to, _ = TL.gqa_attention(tx, tp, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                             positions=tpos, use_flash=True)
    np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2e-5, atol=2e-5)


def test_rope_swiglu_cross_entropy_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 108, dtype=np.int32), (2, 8))
    np.testing.assert_allclose(
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos))),
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos.copy())).numpy(),
        rtol=2e-5, atol=2e-5)
    h = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w1, w3 = (rng.standard_normal((64, 128)).astype(np.float32) * 0.1 for _ in range(2))
    w2 = rng.standard_normal((128, 64)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        np.asarray(JL.swiglu(*map(jnp.asarray, (h, w1, w3, w2)))),
        TL.swiglu(*map(torch.from_numpy, (h, w1, w3, w2))).numpy(), rtol=2e-5, atol=2e-5)
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 8)).astype(np.int32)
    np.testing.assert_allclose(
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        float(TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))),
        rtol=1e-6)


def test_interop_carries_bf16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32).reshape(4, 6),
                               jnp.bfloat16))
    t = interop.tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (4, 6)
    assert np.array_equal(t.float().numpy(), a.astype(np.float32))
