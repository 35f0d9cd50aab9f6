"""The numeric choices of the narrow bf16 PF-head kernels, emulated on the
CPU at the zeng width (Cmid 128; the threshold mask also at the R50
head's 512, which the wide K2 bf16 takes too) and held to the rounding
points the port's plain versions and the Pallas kernels use.

* K1 bf16 forms bf16(relu(a)) with one ``cvt.rn.relu.bf16x2.f32`` per two
  middle values (``csrc/fused_head.cu``, ``cvt_relu_bf16x2``): round to
  nearest even, then negative results to 0, NaN kept. Emulated bit for bit
  on float32 bits and held to torch's ``relu(a).to(bfloat16)`` (the plain
  version) on negatives, +-0, ties, subnormals, overflow and NaN, and to
  JAX's ``maximum(a, 0).astype(bfloat16)`` (the Pallas kernel) wherever
  neither a nor the result is subnormal (XLA on the CPU flushes those to
  0, as the card's cvt does not).
* K2 bf16 takes the ReLU mask fmaf(gis, mid, c1) > 0 as mid' > t, with t
  found once per channel by bisection over the ordered floats
  (``relu_threshold``) and mid' = sign(gis) mid. Emulated with the fma's
  sign computed exactly (fractions) and held to the fma's mask on random
  middle values and on the floats next to each threshold.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def cvt_rn_relu_bf16(a: np.ndarray) -> np.ndarray:
    """The bf16 bits ``cvt.rn.relu.bf16x2.f32`` gives for float32 ``a``."""
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) & 0xFFFF
    out = np.where(rounded & 0x8000, 0, rounded)
    return np.where(np.isnan(a), 0x7FFF, out).astype(np.uint16)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _same_values(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal as numbers (+0 == -0), NaN where the other is NaN."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    return bool(np.array_equal(np.isnan(a), np.isnan(b))
                and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)]))


def test_cvt_relu_bf16_matches_bf16_of_relu():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)                     # bf16's ulp at 1
    special = np.array([
        -1.5, -1e-30, -np.inf, -2.0 ** -149, -0.0, 0.0, 2.0 ** -149,
        2.0 ** -134, 2.0 ** -133, 2.0 ** -140, 3.0e-39,
        one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2.0 ** -20,
        -(one + ulp / 2), 255.5, 3.3895e38, 3.39e38, 3.4028e38, np.inf,
        np.nan, -np.nan], dtype=np.float32)
    rng = np.random.default_rng(0)
    a = np.concatenate([special, rng.standard_normal(128 * 1024)
                        .astype(np.float32) * 3]).astype(np.float32)
    got = bf16_values(cvt_rn_relu_bf16(a))
    plain = torch.relu(torch.from_numpy(a)).to(torch.bfloat16).float()
    pallas = np.asarray(jnp.maximum(jnp.asarray(a), 0)
                        .astype(jnp.bfloat16).astype(jnp.float32))
    assert _same_values(got, plain.numpy())
    normal = ~((np.abs(a) < 2.0 ** -126) | (np.abs(got) < 2.0 ** -126)) \
        | (got == 0) & (a <= 0)
    assert normal.sum() > 128 * 1000
    assert _same_values(got[normal], pallas[normal])
    # Ties go to the even neighbour; NaN stays NaN (an fmaxf ReLU would
    # give 0 there).
    assert got[11] == 1.0                           # 1 + ulp/2 -> 1
    assert got[12] == 1.0 + 2 * ulp                 # 1 + 3ulp/2 -> 1 + 2ulp
    assert got[13] == 1.0 + ulp                     # above the tie
    nans = slice(special.size - 2, special.size)
    assert np.isnan(got[nans]).all() and np.fmax(np.nan, 0.0) == 0.0
    assert np.isinf(got[special.size - 4]) and got[0] == 0.0


def _key(f: float) -> int:
    """float32 -> an integer in the floats' order (-0 and +0 both 0)."""
    b = int(np.float32(f).view(np.int32))
    return b if b >= 0 else -(b & 0x7FFFFFFF)


def _from_key(k: int) -> np.float32:
    bits = k if k >= 0 else (0x80000000 | -k)
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]


def _fma_positive(g, m, c1) -> bool:
    """fmaf(g, m, c1) > 0 for finite float32 operands: the exact value
    rounds (to nearest even) to a positive float32 exactly when it is
    above 2^-150, half the smallest subnormal."""
    exact = Fraction(float(g)) * Fraction(float(m)) + Fraction(float(c1))
    return exact > Fraction(1, 2 ** 150)


def relu_threshold(g, c1) -> np.float32:
    """``relu_threshold`` of ``csrc/fused_head.cu`` for finite g >= 0 and
    c1: the largest float at which fmaf(g, m, c1) is not positive."""
    if g == 0:
        return np.float32(-np.inf if c1 > 0 else np.inf)
    lo, hi = _key(-np.inf), _key(np.inf)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if _fma_positive(g, _from_key(mid), c1):
            hi = mid
        else:
            lo = mid
    return _from_key(lo)


@pytest.mark.parametrize('cmid', [128, 512])
def test_relu_threshold_reproduces_the_fma_mask(cmid):
    # Cmid 128: the narrow K2 bf16's channels; 512: the wide one's (the
    # R50 head), whose gamma == 0 channels give gis == 0 and whose
    # negative gamma negative gis, as the narrow head's do.
    rng = np.random.default_rng(1 if cmid == 128 else cmid)
    gis = (rng.standard_normal(cmid) * 0.3 + 1.0) * 10.0 ** rng.uniform(
        -3, 3, cmid) * rng.choice([-1.0, 1.0], cmid)
    c1 = rng.standard_normal(cmid) * 10.0 ** rng.uniform(-3, 3, cmid)
    gis[:4] = [0.0, 0.0, 1e-38, -7.5]
    c1[:4] = [0.5, -0.5, 1.0, 0.0]
    c1[4], c1[5] = 3e-41, -3e-41                    # subnormal offsets
    if cmid > 128:
        gis[cmid - 3:] = [0.0, -0.0, -1e-30]        # gamma 0; a tiny gis < 0
        c1[cmid - 3:] = [-2.0, 3.0, 0.25]
    assert (gis < 0).sum() > cmid // 4 and (gis == 0).sum() >= 2
    gis, c1 = gis.astype(np.float32), c1.astype(np.float32)
    for g, c in zip(gis, c1):
        sign = np.float32(-1.0 if g < 0 else 1.0)
        t = relu_threshold(abs(g), c)
        mids = np.clip(rng.standard_normal(24) * 4 * (abs(float(t)) + 1),
                       -3e38, 3e38).astype(np.float32)
        if np.isfinite(t):
            # The floats next to the threshold, on both sides.
            near = [_from_key(_key(t) + d) for d in range(-3, 4)]
            mids = np.concatenate([mids, np.float32(sign) * np.array(
                near, dtype=np.float32)])
            assert not _fma_positive(abs(g), t, c)
            assert _fma_positive(abs(g), _from_key(_key(t) + 1), c)
        for mid in mids:
            # The kernel's mask: mid' = sign(gis) mid against t; the
            # Pallas kernel's: fmaf(gis, mid, c1) > 0.
            assert (sign * mid > t) == _fma_positive(g, mid, c), (g, c, mid)
