"""The plain versions behind the two flash backwards, on the CPU:
`attention_bwd_rounded` (the wgmma kernel's rounding points),
`attention_bwd_3xtf32` (the TF32 kernel's: every product split as the
kernel splits it) and `attention_lse` (the log-sum-exp both forwards keep
for them), against float64 autograd of the port's plain attention, against
`jax.grad` of the reference's `ref.attention_ref` and JAX's log-sum-exp of
the reference's scores, on the same numpy-seeded inputs.

Tolerances: bfloat16 gradients within BWD_BF16_REL_ERR (5e-3) in relative
norm of float64 autograd and of JAX's float32 gradients on the same
bfloat16-valued inputs (P and dS round to bfloat16 before their products,
the gradients round once, Delta reads the bfloat16 forward output); in
float32, where nothing rounds, within rtol 1e-5 / atol 1e-6 of
`attention_bwd_plain` (another sum order); the log-sum-exp within 1e-5
(float32 scores summed in another order). `attention_bwd_3xtf32` on float32
inputs within BWD_F32_ERR (2e-5 of the largest entry) of float64 autograd
and of JAX's float32 gradients, and its single TF32 pass (`passes=1`)
outside it: the control that shows the split is needed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as tfa

#: (B, Hq, Hkv, Sq, Skv, D): GQA groups 1, 2 and 4, Sq < Skv, Sq > Skv
#: (under `causal` its first rows see no key), D 8 to 96
SHAPES = [(1, 2, 2, 32, 32, 16), (2, 4, 2, 40, 70, 32), (1, 8, 2, 1, 37, 64),
          (1, 4, 1, 50, 20, 96), (2, 2, 1, 65, 130, 8)]


def _case(b, hq, hkv, sq, skv, d, seed):
    """q, k, v, dout as numpy float32 arrays whose values are bfloat16."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d)))
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrs]


def _case32(b, hq, hkv, sq, skv, d, seed):
    """q, k, v, dout as float32 tensors (values that need the split)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d), (b, hq, sq, d))]


def _max_err(got, exact) -> float:
    """BWD_F32_ERR's reading: max |a - x| over max |x|, worst gradient."""
    return max(float((torch.as_tensor(np.asarray(a, np.float64))
                      - torch.as_tensor(np.asarray(x, np.float64))).abs().max()
                     / torch.as_tensor(np.asarray(x, np.float64)).abs().max())
               for a, x in zip(got, exact))


def _bf16(*arrs):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]


def _rel(a, x):
    a, x = torch.as_tensor(np.asarray(a, np.float64)), torch.as_tensor(np.asarray(x, np.float64))
    return float((a - x).norm() / x.norm())


def _forward(q, k, v, causal):
    """The bfloat16 forward output as the backward reads it: the plain
    version's, with 0 where a row sees no key (the plain softmax gives NaN
    there; the kernels' output is finite)."""
    return torch.nan_to_num(tfa.attention_rounded(q, k, v, causal))


def _seen(sq, skv, causal):
    """The first query row that sees a key."""
    return max(0, sq - skv) if causal else 0


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_rounded_backward_matches_float64_autograd_in_bf16(b, hq, hkv, sq, skv, d, causal):
    """`attention_bwd_rounded` on bfloat16 inputs, with the bfloat16 forward
    output of `attention_rounded`: each gradient in bfloat16 and within
    BWD_BF16_REL_ERR of float64 autograd of `attention_plain`; a row that
    sees no key gets a zero dq (autograd gives it NaN, so it is left out)."""
    q, k, v, dout = _bf16(*_case(b, hq, hkv, sq, skv, d, sq + skv + d))
    out = _forward(q, k, v, causal)
    got = tfa.attention_bwd_rounded(q, k, v, out, dout, causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    lo = _seen(sq, skv, causal)
    assert not got[0][:, :, :lo].any()
    qq, kk, vv = (t.double().requires_grad_() for t in (q[:, :, lo:], k, v))
    exact = torch.autograd.grad(tfa.attention_plain(qq, kk, vv, causal), (qq, kk, vv),
                                dout[:, :, lo:].double())
    for a, x in zip((got[0][:, :, lo:],) + got[1:], exact):
        assert a.shape == x.shape
        assert _rel(a.double(), x) <= tfa.BWD_BF16_REL_ERR


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [s for s in SHAPES if s[3] <= s[4]])
@pytest.mark.parametrize("causal", [True, False])
def test_rounded_backward_matches_jax_grad_of_the_reference(b, hq, hkv, sq, skv, d, causal):
    """The same bfloat16-valued numpy inputs through `jax.grad` of
    `ref.attention_ref` in float32 and through `attention_bwd_rounded` in
    bfloat16: within BWD_BF16_REL_ERR in relative norm, each gradient."""
    q, k, v, w = _case(b, hq, hkv, sq, skv, d, 2 * sq + skv)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(ref.attention_ref(q_, k_, v_, causal) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tw = _bf16(q, k, v, w)
    out = _forward(tq, tk, tv, causal)
    got = tfa.attention_bwd_rounded(tq, tk, tv, out, tw, causal)
    for a, x in zip(got, want):
        assert _rel(a.float().numpy(), np.asarray(x)) <= tfa.BWD_BF16_REL_ERR


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_rounded_backward_in_float32_is_the_plain_backward(b, hq, hkv, sq, skv, d, causal):
    """In float32 nothing rounds, so `attention_bwd_rounded` is
    `attention_bwd_plain` up to the sum order (P against the log-sum-exp
    rather than the row max and sum)."""
    q, k, v, dout = map(torch.from_numpy, _case(b, hq, hkv, sq, skv, d, skv))
    out = torch.nan_to_num(tfa.attention_plain(q, k, v, causal))   # NaN where no key is seen
    for a, p in zip(tfa.attention_bwd_rounded(q, k, v, out, dout, causal),
                    tfa.attention_bwd_plain(q, k, v, out, dout, causal)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_logsumexp_of_the_reference_scores(b, hq, hkv, sq, skv, d, causal):
    """`attention_lse` against `jax.nn.logsumexp` of the scores as
    `ref.attention_ref` forms them (kv heads tiled group-major, times
    1/sqrt(D), masked to -inf): within 1e-5 where a row sees a key, +inf
    where it sees none (JAX gives -inf there)."""
    q, k, _, _ = _case(b, hq, hkv, sq, skv, d, 3 * sq + d)
    kk = jnp.tile(jnp.asarray(k), (1, hq // hkv, 1, 1))
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) * (1.0 / np.sqrt(d))
    if causal:
        mask = np.arange(skv)[None, :] <= np.arange(sq)[:, None] + (skv - sq)
        logits = jnp.where(mask[None, None], logits, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    got = tfa.attention_lse(*_bf16(q, k), causal).numpy()
    assert got.shape == (b, hq, sq) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(want), np.isposinf(got))
    seen = np.isfinite(want)
    np.testing.assert_allclose(got[seen], want[seen], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_dropping_a_key_misses_the_rounded_tolerance(b, hq, hkv, sq, skv, d, causal):
    """The fault the card's check against `attention_bwd_rounded` must see:
    key 0's row of dK and dV set to 0 moves the gradients by more than ten
    times BWD_ROUNDED_REL_ERR (worst relative norm of the three)."""
    q, k, v, dout = _bf16(*_case(b, hq, hkv, sq, skv, d, 5 * skv))
    out = _forward(q, k, v, causal)
    got = tfa.attention_bwd_rounded(q, k, v, out, dout, causal)
    dropped = [g.clone() for g in got]
    for g in dropped[1:]:
        g[:, :, 0] = 0
    moved = max(_rel(a.double(), r.double()) for a, r in zip(dropped, got))
    assert moved > 10 * tfa.BWD_ROUNDED_REL_ERR


def _tf32_case(b, hq, hkv, sq, skv, d, causal, passes):
    """`attention_bwd_3xtf32` on float32 inputs and float64 autograd of
    `attention_plain`, each over the rows that see a key (autograd gives the
    others NaN), and the model's dq on the rows that see none."""
    q, k, v, dout = _case32(b, hq, hkv, sq, skv, d, 7 * sq + skv + d)
    out = torch.nan_to_num(tfa.attention_plain(q, k, v, causal))   # NaN where no key is seen
    got = tfa.attention_bwd_3xtf32(q, k, v, out, dout, causal, passes=passes)
    lo = _seen(sq, skv, causal)
    qq, kk, vv = (t.double().requires_grad_() for t in (q[:, :, lo:], k, v))
    exact = torch.autograd.grad(tfa.attention_plain(qq, kk, vv, causal), (qq, kk, vv),
                                dout[:, :, lo:].double())
    return (got[0][:, :, lo:],) + got[1:], exact, got[0][:, :, :lo]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_matches_float64_autograd(b, hq, hkv, sq, skv, d, causal):
    """The TF32 kernel's plain version in float32: each gradient float32 and
    within BWD_F32_ERR of float64 autograd; a row that sees no key gets a
    zero dq."""
    got, exact, unseen = _tf32_case(b, hq, hkv, sq, skv, d, causal, passes=3)
    assert all(a.dtype == torch.float32 and a.shape == x.shape for a, x in zip(got, exact))
    assert not unseen.any()
    assert _max_err(got, exact) <= tfa.BWD_F32_ERR


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_single_tf32_pass_misses_the_float32_tolerance(b, hq, hkv, sq, skv, d, causal):
    """The control: with big*big alone (`passes=1`, one TF32 pass a product)
    the same gradients miss BWD_F32_ERR (by 27x or more at these shapes), so
    the tolerance sees a kernel that drops the split's small terms."""
    got, exact, _ = _tf32_case(b, hq, hkv, sq, skv, d, causal, passes=1)
    assert _max_err(got, exact) > tfa.BWD_F32_ERR


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [s for s in SHAPES if s[3] <= s[4]])
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_matches_jax_grad_of_the_reference(b, hq, hkv, sq, skv, d, causal):
    """The same float32 numpy inputs through `jax.grad` of `ref.attention_ref`
    and through `attention_bwd_3xtf32` (given `attention_plain`'s output):
    within BWD_F32_ERR of the largest entry, each gradient."""
    q, k, v, w = (t.numpy() for t in _case32(b, hq, hkv, sq, skv, d, 11 * sq + d))
    want = jax.grad(lambda q_, k_, v_: jnp.sum(ref.attention_ref(q_, k_, v_, causal) * w),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    out = tfa.attention_plain(tq, tk, tv, causal)
    got = tfa.attention_bwd_3xtf32(tq, tk, tv, out, tw, causal)
    assert _max_err([a.numpy() for a in got], [np.asarray(x) for x in want]) <= tfa.BWD_F32_ERR


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", SHAPES)
def test_3xtf32_backward_on_bf16_is_the_plain_backward(b, hq, hkv, sq, skv, d):
    """bfloat16 inputs (the TF32 kernel's route for D % 8 != 0) are exact in
    TF32, so only P and dS are split: the model stays within BWD_BF16_REL_ERR
    of float64 autograd, as `attention_bwd_plain` does."""
    q, k, v, dout = _bf16(*_case(b, hq, hkv, sq, skv, d, 13 * skv + d))
    out = _forward(q, k, v, True)
    got = tfa.attention_bwd_3xtf32(q, k, v, out, dout, True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    lo = _seen(sq, skv, True)
    assert not got[0][:, :, :lo].any()
    qq, kk, vv = (t.double().requires_grad_() for t in (q[:, :, lo:], k, v))
    exact = torch.autograd.grad(tfa.attention_plain(qq, kk, vv, True), (qq, kk, vv),
                                dout[:, :, lo:].double())
    for a, x in zip((got[0][:, :, lo:],) + got[1:], exact):
        assert _rel(a.double(), x) <= tfa.BWD_BF16_REL_ERR
