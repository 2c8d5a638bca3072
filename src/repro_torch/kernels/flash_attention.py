"""Causal GQA attention: the flash kernel and its plain version.

Port of `repro.kernels.flash_attention.flash_attention` (the Pallas
`_flash_kernel`). q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), float32 or
bfloat16 -> (B, Hq, Sq, D) in q's dtype. Query head h reads kv head
h % Hkv: the group-major map of the Pallas index map (flash_attention.py
:119) and of `ref.attention_ref`. (The Pallas module docstring's
"h // group" is stale, and torch's `enable_gqa` uses h // group, the other
map.) With `causal`, query i sees kv positions <= i + Skv - Sq.

On the card there are two kernels, and `route(dtype, D)` picks one:
bfloat16 with D % 8 == 0 goes to `csrc/flash_attention_wgmma.cu` (`wgmma`
fed by TMA, counted as `flash_attention`); float32, and bfloat16 with
D % 8 != 0 (TMA needs 16-byte row strides), go to `csrc/flash_attention.cu`
(`mma.sync` in TF32, counted as `flash_attention_f32`), which keeps float32
accuracy by the 3xTF32 split: each float32 operand x is split into
big = x rounded to TF32 and small = x - big rounded to TF32, and a product
is small*big + big*small + big*big (`split_tf32`, `attention_3xtf32`; a
bfloat16 value is exact in TF32, so its small half is zero). Both kernels
run an online softmax over kv tiles with float32 statistics, round P to
bfloat16 before P.V for bfloat16 inputs, and take any Sq and Skv and D up
to 128. The plain version is `ref.attention_ref`'s formulation: kv heads
tiled group-major, scores in q's dtype, softmax in float32, P cast to q's
dtype. Each kernel and the plain version agree within 2e-4 in float32 and
5e-2 in bfloat16, and in bfloat16 also within BF16_REL_ERR in relative norm
(||kernel - plain|| / ||plain||): outputs average many values of v and are
small at long Skv, so an absolute 5e-2 alone would pass a kernel that drops
keys. The sharp bfloat16 check is against `attention_rounded`, the plain
version that rounds where the kernels round (float32 scores, P rounded to
bfloat16, a float32 P.V, the output rounded to bfloat16), within
ROUNDED_REL_ERR in relative norm.

The backward, for training, has no Pallas counterpart (the reference
differentiates XLA's attention) and two kernels on the card, picked by
`route_bwd(dtype, D)` with `route`'s rule. From q, k, v, the forward's
output, its gradient and the forward's log-sum-exp (`flash_attention_cuda(
..., with_lse=True)`, which both forward routes write) each gives (dq, dk,
dv) in q's dtype in three launches with no float atomics, so a call is
bit-for-bit repeatable. bfloat16 with D % 8 == 0 goes to
`csrc/flash_attention_bwd_wgmma.cu` (counted as
`flash_attention_bwd_wgmma`): `wgmma` fed by TMA, P and dS rounded to
bfloat16 before their products, float32 sums; its plain version at the same
rounding points is `attention_bwd_rounded`, held to it within
BWD_ROUNDED_REL_ERR. float32, and bfloat16 with D % 8 != 0, go to
`csrc/flash_attention_bwd.cu` (counted as `flash_attention_bwd`): `mma.sync`
in TF32 with every product split as the forward splits it (3xTF32), the
exact derivative at the given inputs in float32, whose plain version is
`attention_bwd_plain` and, at the kernel's rounding points,
`attention_bwd_3xtf32`. Both kernels are held to autograd of
`attention_plain` in float64 on the same inputs: within BWD_F32_ERR
(relative to the largest gradient entry) for float32 inputs, and within
BWD_BF16_REL_ERR in relative norm for bfloat16 inputs, whose output and
dout round to bfloat16.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _counting
from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: the two kernels, by their names in `_build.KERNELS`: wgmma on bfloat16,
#: mma.sync in TF32 (3xTF32 for float32) on the rest
TENSOR_CORES, TF32 = "flash_attention", "flash_attention_f32"
#: the two backward kernels, by their names in `_build.KERNELS`: mma.sync in
#: TF32 (3xTF32 for float32) for float32 and bfloat16 with D % 8 != 0, wgmma
#: on the rest of bfloat16
BACKWARD, BACKWARD_WGMMA = "flash_attention_bwd", "flash_attention_bwd_wgmma"
#: bfloat16 kernel vs plain version, ||a - p|| / ||p||: the worst reading
#: on an H100 (chip_smoke.py's sweep and granite shapes) is 6.4e-3, for the
#: wgmma kernel. The plain version rounds its
#: scores to bfloat16 and the kernels do not; that gap hides small faults
#: such as one dropped key in a long row
BF16_REL_ERR = 1e-2
#: bfloat16 kernel vs `attention_rounded`, ||a - r|| / ||r||: what is left is
#: the rounding of P against a running rather than the final row max, and of
#: the output (about 2e-3); dropping one key from rows of 1,024 keys moves
#: the output by about 3e-2
ROUNDED_REL_ERR = 5e-3
#: backward vs float64 autograd for float32 inputs: max |a - x| over
#: max |x|, per gradient (float32 sums of up to Skv * group products; the
#: plain version reads 2e-7 to 6e-7 on the CPU)
BWD_F32_ERR = 2e-5
#: backward vs float64 autograd for bfloat16 inputs, ||a - x|| / ||x||: the
#: gradients round to bfloat16 (2^-9) and Delta uses the forward's bfloat16
#: output (the plain version reads 1.6e-3 to 2.2e-3 on the CPU)
BWD_BF16_REL_ERR = 5e-3
#: the wgmma backward vs `attention_bwd_rounded`, ||a - r|| / ||r|| per
#: gradient: both round P and dS to bfloat16 at the same points, so what is
#: left is a float32 ulp of their inputs (sum order, exp2 against exp, the
#: forward's online log-sum-exp) flipping a bfloat16 rounding now and then;
#: dropping key 0's row of dK and dV moves them by at least 3e-2 (the
#: smallest share of one key among up to 1,024, non-causal; a causal key 0
#: is seen by every query and weighs far more)
BWD_ROUNDED_REL_ERR = 2e-3
#: the backward's scratch rows per (batch, q head), on both routes: Sq
#: rounded up to a multiple of this
BWD_SQ_ALIGN = 128


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         "expected (B, Hq, Sq, D) and two (B, Hkv, Skv, D)")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair "
                         "(batch, head dim, or Hq % Hkv)")
    return b, hq, k.shape[1], sq, k.shape[2], d


def _masked(s: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scores (..., Sq, Skv) with -inf where a query does not see the kv
    position: under `causal`, query i sees positions <= i + Skv - Sq."""
    if not causal:
        return s
    sq, skv = s.shape[-2:]
    qpos = torch.arange(sq, device=s.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=s.device)[None, :]
    return torch.where(kpos <= qpos, s, float("-inf"))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version, as `ref.attention_ref` computes it."""
    _, hq, hkv, _, _, d = _shapes(q, k, v)
    group = hq // hkv
    kk = k.repeat(1, group, 1, 1)                  # group-major: head h -> h % hkv
    vv = v.repeat(1, group, 1, 1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale.to(q.device)
    logits = _masked(logits, causal)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)


def attention_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Plain version at the flash kernels' rounding points: scores q.k in
    float32, softmax statistics in float32, the unnormalised P rounded to
    q's dtype before a float32 P.V, divided by the float32 row sum of the
    unrounded P, and the output rounded to q's dtype."""
    _, hq, hkv, _, _, d = _shapes(q, k, v)
    group = hq // hkv
    kk = k.repeat(1, group, 1, 1).float()          # group-major: head h -> h % hkv
    vv = v.repeat(1, group, 1, 1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (1.0 / d ** 0.5)
    s = _masked(s, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), vv)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, on the bits: add half of the 13 dropped bits' range to the
    magnitude, then clear them (a carry moves into the exponent, so the
    largest values round to inf). What `cvt.rna.tf32.f32` does."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r)
    return r.to(torch.int32).view(torch.float32).view(x.shape)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 `x` as the TF32 flash kernel splits an
    operand: big = x rounded to TF32, small = (x - big) rounded to TF32 (the
    difference is exact in float32), so big + small is x within 2^-22 of |x|
    (2^-137 absolute among subnormals, where TF32 keeps a fixed exponent).
    Where big is not finite small is 0 (the kernel is given finite inputs)."""
    x = x.float()
    big = _rna_tf32(x)
    small = torch.where(torch.isfinite(big), _rna_tf32(x - big), 0.0)
    return big, small


def attention_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool = True, passes: int = 3) -> torch.Tensor:
    """Plain version of the TF32 flash kernel: every product of q.k and of
    P.V split as the kernel splits it, small*big + big*small + big*big, in
    float32 (`passes=1`: big*big alone, a single TF32 pass); P unnormalised
    against the row max, rounded to q's dtype for bfloat16, divided by the
    float32 row sum of the unrounded P; the output in q's dtype."""
    if passes not in (1, 3):
        raise ValueError(f"passes={passes}: 1 or 3")
    _, hq, hkv, _, _, d = _shapes(q, k, v)
    group = hq // hkv
    qb, qs = split_tf32(q)
    kb, ks = split_tf32(k.repeat(1, group, 1, 1))   # group-major: head h -> h % hkv
    vb, vs = split_tf32(v.repeat(1, group, 1, 1))

    def prod(eq, ab, as_, bb, bs):
        out = torch.einsum(eq, ab, bb)
        if passes == 3:
            out = torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs) + out
        return out

    s = prod("bhqd,bhkd->bhqk", qb, qs, kb, ks) * (1.0 / d ** 0.5)
    s = _masked(s, causal)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pb, ps = split_tf32(p.to(q.dtype))
    o = prod("bhqk,bhkd->bhqd", pb, ps, vb, vs)
    return (o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: (dq, dk, dv) in the inputs'
    dtypes, computed in float32 from the inputs as given. P is the softmax of
    the scaled scores, Delta = rowsum(dout o out) uses the forward's `out`,
    dS = P o (dP - Delta); dk and dv sum over the query heads that read each
    kv head (h % Hkv). A row that sees no kv position gets a zero gradient."""
    b, hq, hkv, _, skv, d = _shapes(q, k, v)
    group = hq // hkv
    qf, dof = q.float(), dout.float()
    kk = k.float().repeat(1, group, 1, 1)          # group-major: head h -> h % hkv
    vv = v.float().repeat(1, group, 1, 1)
    scale = 1.0 / d ** 0.5
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale
    s = _masked(s, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(b, group, hkv, skv, d).sum(dim=1)
    dv = dv.reshape(b, group, hkv, skv, d).sum(dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                         passes: int = 3
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the TF32 backward kernel at its rounding points:
    every product (S = q k^T, dP = dout v^T, dV = P^T dout, dK = dS^T q,
    dQ = dS k) with both operands split as the kernel splits them
    (`split_tf32`), small*big + big*small + big*big in float32 (`passes=1`:
    big*big alone, a single TF32 pass); P = exp(s - lse) against the
    log-sum-exp of those scores, Delta = rowsum(dout o out) in float32,
    dS = P o (dP - Delta); dk and dv summed over the query heads that read
    each kv head, dK and dQ scaled by 1/sqrt(D), each gradient rounded to
    q's dtype once. A bfloat16 operand's small half is zero. A row that sees
    no kv position gets a zero gradient."""
    if passes not in (1, 3):
        raise ValueError(f"passes={passes}: 1 or 3")
    b, hq, hkv, _, skv, d = _shapes(q, k, v)
    group = hq // hkv
    kk = k.repeat(1, group, 1, 1)                  # group-major: head h -> h % hkv
    vv = v.repeat(1, group, 1, 1)

    def prod(eq, x, y):
        xb, xs = split_tf32(x)
        yb, ys = split_tf32(y)
        out_ = torch.einsum(eq, xb, yb)
        if passes == 3:
            out_ = torch.einsum(eq, xs, yb) + torch.einsum(eq, xb, ys) + out_
        return out_

    scale = 1.0 / d ** 0.5
    s = _masked(prod("bhqd,bhkd->bhqk", q, kk) * scale, causal)
    p = torch.exp(s - _lse(s)[..., None])
    dp = prod("bhqd,bhkd->bhqk", dout, vv)
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = prod("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = prod("bhqk,bhqd->bhkd", ds, q).reshape(b, group, hkv, skv, d).sum(dim=1)
    dv = prod("bhqk,bhqd->bhkd", p, dout).reshape(b, group, hkv, skv, d).sum(dim=1)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """(B, Hq, Sq) float32 natural log-sum-exp of each query row's scaled
    scores (q.k in float32, times 1/sqrt(D)), +inf for a row that sees no kv
    position: what either forward writes given `with_lse`."""
    _, hq, hkv, _, _, d = _shapes(q, k, k)
    kk = k.float().repeat(1, hq // hkv, 1, 1)      # group-major: head h -> h % hkv
    return _lse(_masked(torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (1.0 / d ** 0.5),
                        causal))


def _lse(s: torch.Tensor) -> torch.Tensor:
    """Log-sum-exp over the last axis, +inf where every score is -inf."""
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(lse == float("-inf"), float("inf"), lse)


def attention_bwd_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, dout: torch.Tensor, causal: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the wgmma backward at its rounding points: scores
    q.k in float32, P = exp(s - lse) in float32 against the row's float32
    log-sum-exp (`attention_lse`), Delta = rowsum(dout o out) in float32,
    dS = P o (dP - Delta) in float32; P and dS rounded to q's dtype before
    the products dV = P^T dout, dK = dS^T q and dQ = dS k, which sum in
    float32 (dk and dv over the query heads that read each kv head), dK and
    dQ then scaled by 1/sqrt(D); each gradient rounded to q's dtype once. A
    row that sees no kv position gets a zero gradient."""
    b, hq, hkv, _, skv, d = _shapes(q, k, v)
    group = hq // hkv
    qf, dof = q.float(), dout.float()
    kk = k.float().repeat(1, group, 1, 1)          # group-major: head h -> h % hkv
    vv = v.float().repeat(1, group, 1, 1)
    scale = 1.0 / d ** 0.5
    s = _masked(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale, causal)
    p = torch.exp(s - _lse(s)[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).reshape(b, group, hkv, skv, d).sum(dim=1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).reshape(b, group, hkv, skv, d).sum(dim=1)
    return dq.to(q.dtype), (dk * scale).to(k.dtype), dv.to(v.dtype)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes inputs of `dtype` and head dim `d` on the card:
    wgmma for bfloat16 with d % 8 == 0, else the TF32 mma.sync kernel."""
    return TENSOR_CORES if dtype == torch.bfloat16 and d % 8 == 0 else TF32


def route_bwd(dtype: torch.dtype, d: int) -> str:
    """The backward kernel for `dtype` and head dim `d`, by `route`'s rule:
    wgmma for bfloat16 with d % 8 == 0, else the TF32 mma.sync kernel."""
    return BACKWARD_WGMMA if route(dtype, d) == TENSOR_CORES else BACKWARD


def bwd_stats_floats(b: int, hq: int, sq: int) -> int:
    """float32 room for either backward's scratch: two planes (each row's
    log-sum-exp in the log2 domain, then its Delta) of b * hq rows of Sq
    rounded up to BWD_SQ_ALIGN."""
    return 2 * b * hq * (-(-sq // BWD_SQ_ALIGN) * BWD_SQ_ALIGN)


def tf32_padded_dim(d: int) -> int:
    """The TF32 kernel's padded head dim: 16, 32, 64, 96 or 128."""
    return next(p for p in (16, 32, 64, 96, 128) if d <= p)


def tf32_scratch_floats(b: int, hkv: int, skv: int, d: int) -> int:
    """float32 room for the TF32 kernel's split K and V planes: per kv head,
    2 DP floats a kv row (K) and 4 DP a pair of kv rows (V)."""
    dp = tf32_padded_dim(d)
    return b * hkv * (skv * 2 * dp + (skv + 1) // 2 * 4 * dp)


#: flash_attention_wgmma_launch's: q, k, v, out, lse; B, Hq, Hkv, Sq, Skv,
#: D; scale; causal; stream
_WGMMA_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6
                   + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
#: flash_attention_launch's: the wgmma entry's, with the scratch pointer and
#: its size after lse and the dtype before the stream
_ARGTYPES = (_WGMMA_ARGTYPES[:5] + (ctypes.c_void_p, ctypes.c_int)
             + _WGMMA_ARGTYPES[5:13] + (ctypes.c_int, ctypes.c_void_p))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, with_lse: bool = False):
    """Launch the kernel that `route` picks, on PyTorch's current stream.
    With `with_lse` returns (out, lse): lse (B, Hq, Sq) float32 as
    `attention_lse` computes it, +inf where a row sees no kv position, for
    the backward; the output is the same bits either way."""
    dev = q.device
    b, hq, hkv, sq, skv, d = _shapes(q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    kernel = route(q.dtype, d)
    p_q = _build.require(q, "q", q.dtype, 4, dev)
    p_k = _build.require(k, "k", q.dtype, 4, dev)
    p_v = _build.require(v, "v", q.dtype, 4, dev)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if skv < 1:
        raise ValueError("no kv positions")
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if with_lse else None
    args = (b, hq, hkv, sq, skv, d, 1.0 / (d ** 0.5), int(causal))
    if kernel == TENSOR_CORES:
        if any(p % 16 for p in (p_q, p_k, p_v)):
            raise ValueError("q, k and v must be 16-byte aligned for TMA")
        fn = _build.entry("flash_attention_wgmma", "flash_attention_wgmma_launch",
                          _WGMMA_ARGTYPES)
        args = (p_q, p_k, p_v, out.data_ptr(), None if lse is None else lse.data_ptr()) + args
    else:
        room = tf32_scratch_floats(b, hkv, skv, d)
        if room >= 1 << 31:
            raise ValueError(f"k and v of {room} split floats: more than the kernel "
                             "indexes")
        scratch = torch.empty(room, dtype=torch.float32, device=dev)
        fn = _build.entry("flash_attention", "flash_attention_launch", _ARGTYPES)
        args = (p_q, p_k, p_v, out.data_ptr(), None if lse is None else lse.data_ptr(),
                scratch.data_ptr(), room) + args + (DTYPES[q.dtype],)
    with _build.device_guard(dev):
        err = fn(*args, _build.stream_of(dev))
    _build.check(err, kernel)
    _build.LAUNCHES[kernel] += 1
    return (out, lse) if with_lse else out


#: flash_attention_bwd_wgmma_launch's: q, k, v, out, dout, lse, dq, dk, dv,
#: stats; B, Hq, Hkv, Sq, Skv, D; scale; causal; stream
_BWD_WGMMA_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
                       + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
#: flash_attention_bwd_launch's: the wgmma entry's with the dtype before the
#: stream
_BWD_ARGTYPES = _BWD_WGMMA_ARGTYPES[:-1] + (ctypes.c_int, ctypes.c_void_p)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel that `route_bwd` picks (three launches:
    row statistics, dK/dV, dQ) on PyTorch's current stream; returns (dq,
    dk, dv) in q's dtype. Every backward takes `lse`, the forward's (B, Hq,
    Sq) float32 log-sum-exp (`flash_attention_cuda(..., with_lse=True)`)."""
    dev = q.device
    b, hq, hkv, sq, skv, d = _shapes(q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    kernel = route_bwd(q.dtype, d)
    if lse is None:
        raise ValueError(f"{kernel} ({q.dtype}, D = {d}) takes the forward's lse "
                         "(flash_attention_cuda(..., with_lse=True))")
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse {tuple(lse.shape)} must be {(b, hq, sq)}")
    ptrs = [_build.require(t, name, q.dtype, 4, dev)
            for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out"), (dout, "dout"))]
    p_lse = _build.require(lse, "lse", torch.float32, 3, dev)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be "
                         f"q's shape {tuple(q.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if skv < 1:
        raise ValueError("no kv positions")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(bwd_stats_floats(b, hq, sq), dtype=torch.float32, device=dev)
    args = (*ptrs, p_lse, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            b, hq, hkv, sq, skv, d, 1.0 / (d ** 0.5), int(causal))
    if kernel == BACKWARD:
        fn = _build.entry(BACKWARD, "flash_attention_bwd_launch", _BWD_ARGTYPES)
        args += (DTYPES[q.dtype],)
    else:
        if any(p % 16 for p in ptrs):
            raise ValueError("q, k, v, out and dout must be 16-byte aligned for TMA")
        fn = _build.entry(BACKWARD_WGMMA, "flash_attention_bwd_wgmma_launch",
                          _BWD_WGMMA_ARGTYPES)
    with _build.device_guard(dev):
        err = fn(*args, _build.stream_of(dev))
    _build.check(err, kernel)
    _build.LAUNCHES[kernel] += 1
    return dq, dk, dv


def causal_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs a head attends: query i sees the kv positions
    <= i + Skv - Sq when causal (all Skv otherwise), a + i of them for
    a = Skv - Sq + 1 (none while that is <= 0; the last query sees all)."""
    if not causal:
        return sq * skv
    a = skv - sq + 1
    return _ramp(a + max(0, 1 - a), a + sq - 1)


def _ramp(a: int, b: int) -> int:
    """a + (a + 1) + ... + b (0 when b < a)."""
    return (a + b) * (b - a + 1) // 2 if b >= a else 0


def _require_meta_qkv(q, k, v):
    b, hq, hkv, sq, skv, d = _shapes(q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected float32 or bfloat16")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.require_meta(t, name, q.dtype, 4)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if skv < 1:
        raise ValueError("no kv positions")
    return b, hq, hkv, sq, skv, d


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, with_lse: bool = False):
    """The meta route of `flash_attention_cuda`: its checks and allocations
    (the output, the lse with `with_lse`, the TF32 route's split planes)
    on meta tensors; the work counted under the route's kernel as its
    bound counts it: 4 D operations a (query, key) pair (the TF32 route's
    three products a float32 one are a rate, not more work), q, k, v and
    the output (and lse) moved once."""
    b, hq, hkv, sq, skv, d = _require_meta_qkv(q, k, v)
    kernel = route(q.dtype, d)
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if with_lse else None
    if kernel == TF32:
        torch.empty(tf32_scratch_floats(b, hkv, skv, d), dtype=torch.float32, device=dev)
    pairs = b * hq * causal_pairs(sq, skv, causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + (b * hq * sq * 4 if with_lse
                                                                    else 0)
    _counting.kernel(kernel, 4 * pairs * d, nbytes)
    return (out, lse) if with_lse else out


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The meta route of `flash_attention_bwd_cuda`: its checks and
    allocations (dq, dk, dv and the row-statistics scratch) on meta
    tensors; the work counted under `route_bwd`'s kernel as its bound
    counts it: five products, 10 D operations a pair; q, out, dout, k, v
    and lse read, dq, dk, dv written once."""
    b, hq, hkv, sq, skv, d = _require_meta_qkv(q, k, v)
    kernel = route_bwd(q.dtype, d)
    if lse is None:
        raise ValueError(f"{kernel} ({q.dtype}, D = {d}) takes the forward's lse")
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse {tuple(lse.shape)} must be {(b, hq, sq)}")
    _build.require_meta(lse, "lse", torch.float32, 3)
    for t, name in ((out, "out"), (dout, "dout")):
        _build.require_meta(t, name, q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must be q's shape {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    torch.empty(bwd_stats_floats(b, hq, sq), dtype=torch.float32, device=q.device)
    pairs = b * hq * causal_pairs(sq, skv, causal)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + b * hq * sq * 4
    _counting.kernel(kernel, 10 * pairs * d, nbytes)
    return dq, dk, dv
