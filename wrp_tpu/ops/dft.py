"""Matmul-form DFT operators: direct matrices and Cooley-Tukey radix split.

The direct path (constants.stage1_operators) computes stages 01-04 as two
dense matmuls — ~400M complex MACs per channel-sector.  This module factors
each DFT with one Cooley-Tukey split N = N1*N2 (N1 = 128), cutting MACs
~3.8x while keeping every contraction a matmul:

  X[k1 + N1*k2] = sum_{i2} [ w_N^{i2*k1} * (sum_{i1} x[N2*i1 + i2]
                  * w_{N1}^{i1*k1}) ] * w_{N2}^{i2*k2}

i.e. reshape -> inner 128-point DFT (batched 128x128 matmul) -> twiddle
(elementwise) -> outer N2-point DFT (small matmul) -> index reshuffle.

The radar chain additionally lets us crop the range spectrum to k < m/2
(stage 04 keeps the first half, read.cc:281): only outer-DFT outputs with
k2 < N2/2 are needed, halving the outer stage.

All functions operate on planar (real, imag) float32 pairs — no complex
arrays on device (see pipeline.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RadarConfig
from ..constants import hamming_factors


def _dft(n: int, sign: float = -1.0) -> np.ndarray:
    j = np.arange(n)
    return np.exp(sign * 2.0j * np.pi * np.outer(j, j) / n)


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    """Precomputed factors for one split-radix DFT of length N = n1*n2.

    sign=-1 is the forward DFT; sign=+1 is the conjugated (unnormalised
    inverse) transform used by the Doppler stage's combined conj operator.
    half=True keeps only outer outputs k2 < n2/2 (range-spectrum crop).
    """

    n: int
    n1: int
    n2: int
    f1r: np.ndarray   # [n1, n1] inner DFT
    f1i: np.ndarray
    f2r: np.ndarray   # [n2_keep, n2] outer DFT
    f2i: np.ndarray
    twr: np.ndarray   # [n1, n2] twiddles
    twi: np.ndarray

    @classmethod
    def build(cls, n: int, n1: int = 128, sign: float = -1.0,
              half: bool = False) -> "RadixPlan":
        if n % n1 or n // n1 < 2:
            raise ValueError(f"cannot split {n} with radix {n1}")
        n2 = n // n1
        if half and n2 % 2:
            raise ValueError(f"half-crop needs even n2, got {n2}")
        f1 = _dft(n1, sign)
        f2 = _dft(n2, sign)[: n2 // 2 if half else n2]
        k1 = np.arange(n1)[:, None]
        i2 = np.arange(n2)[None, :]
        tw = np.exp(sign * 2.0j * np.pi * (k1 * i2) / n)
        return cls(
            n=n, n1=n1, n2=n2,
            f1r=f1.real.astype(np.float32), f1i=f1.imag.astype(np.float32),
            f2r=f2.real.astype(np.float32), f2i=f2.imag.astype(np.float32),
            twr=tw.real.astype(np.float32), twi=tw.imag.astype(np.float32),
        )


def _cdot(ar, ai, br, bi, contract, precision):
    """Complex contraction via four real einsums."""
    dot = functools.partial(jnp.einsum, contract, precision=precision)
    return dot(ar, br) - dot(ai, bi), dot(ar, bi) + dot(ai, br)


def radix_dft_rows(xr, xi, plan: RadixPlan, precision) -> Tuple[jax.Array, jax.Array]:
    """DFT along axis -2 (the range axis of [..., m, n]).

    Input [..., n1*n2, cols]; output [..., keep*n1, cols] where row
    k = k1 + n1*k2.
    """
    *lead, m, cols = xr.shape
    assert m == plan.n, (m, plan.n)
    # i = n2*i1 + i2 -> reshape to [..., i1, i2, cols]
    xr = xr.reshape(*lead, plan.n1, plan.n2, cols)
    xi = xi.reshape(*lead, plan.n1, plan.n2, cols)
    # inner DFT over i1: [n1, n1] @ [..., n1, n2*cols]
    tr, ti = _cdot(jnp.asarray(plan.f1r), jnp.asarray(plan.f1i), xr, xi,
                   "ab,...bcd->...acd", precision)
    # twiddle [n1, n2] broadcast over cols
    twr = jnp.asarray(plan.twr)[:, :, None]
    twi = jnp.asarray(plan.twi)[:, :, None]
    ur = tr * twr - ti * twi
    ui = tr * twi + ti * twr
    # outer DFT over i2: out[..., k1, k2, cols]
    vr, vi = _cdot(ur, ui, jnp.asarray(plan.f2r).T, jnp.asarray(plan.f2i).T,
                   "...acd,ce->...aed", precision)
    # k = k1 + n1*k2: order rows as (k2, k1)
    keep = plan.f2r.shape[0]
    vr = jnp.swapaxes(vr, -3, -2).reshape(*lead, keep * plan.n1, cols)
    vi = jnp.swapaxes(vi, -3, -2).reshape(*lead, keep * plan.n1, cols)
    return vr, vi


def radix_dft_cols(xr, xi, plan: RadixPlan, precision) -> Tuple[jax.Array, jax.Array]:
    """DFT along axis -1 (the pulse axis of [..., rows, n])."""
    *lead, rows, n = xr.shape
    assert n == plan.n, (n, plan.n)
    # j = n2*j1 + j2 -> [..., rows, j1, j2]
    xr = xr.reshape(*lead, rows, plan.n1, plan.n2)
    xi = xi.reshape(*lead, rows, plan.n1, plan.n2)
    # inner DFT over j1 (right-multiply by F1^T = F1, symmetric)
    tr, ti = _cdot(xr, xi, jnp.asarray(plan.f1r), jnp.asarray(plan.f1i),
                   "...rbc,bk->...rkc", precision)
    twr = jnp.asarray(plan.twr)
    twi = jnp.asarray(plan.twi)
    ur = tr * twr - ti * twi
    ui = tr * twi + ti * twr
    # outer DFT over j2
    vr, vi = _cdot(ur, ui, jnp.asarray(plan.f2r).T, jnp.asarray(plan.f2i).T,
                   "...rkc,ce->...rke", precision)
    keep = plan.f2r.shape[0]
    # k = k1 + n1*k2 -> order cols as (k2, k1)
    vr = jnp.swapaxes(vr, -2, -1).reshape(*lead, rows, keep * plan.n1)
    vi = jnp.swapaxes(vi, -2, -1).reshape(*lead, rows, keep * plan.n1)
    return vr, vi


# ---------------------------------------------------------------------------
# Stage 01-04 with both DFTs radix-split.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RadixStageOperators:
    """Constants for the radix formulation of stages 01-04."""

    range_plan: RadixPlan       # length-m forward DFT, half-cropped
    doppler_plan: RadixPlan     # length-n conjugated DFT (the combined
                                # conj-fold of stage 03, constants.py)
    w_range: np.ndarray         # [m] window * c (applied pre range-DFT)
    w_doppler: np.ndarray       # [n] window (applied pre Doppler-DFT)

    @classmethod
    def build(cls, cfg: RadarConfig, radix: int = 128) -> "RadixStageOperators":
        wr, wd, c = hamming_factors(cfg)
        return cls(
            range_plan=RadixPlan.build(cfg.num_range_cells, radix,
                                       sign=-1.0, half=True),
            # stage 03's double conjugation folds to x @ conj(F_n)
            # (constants.py derivation) = sign=+1 transform
            doppler_plan=RadixPlan.build(cfg.num_pulses, radix, sign=+1.0),
            w_range=(wr * c).astype(np.float32),
            w_doppler=wd.astype(np.float32),
        )

    @staticmethod
    def supports(cfg: RadarConfig, radix: int = 128) -> bool:
        m, n = cfg.num_range_cells, cfg.num_pulses
        return (m % radix == 0 and m // radix >= 2 and (m // radix) % 2 == 0
                and n % radix == 0 and n // radix >= 2)


def stage01_04_radix(xr, xi, ops: RadixStageOperators,
                     precision=jax.lax.Precision.HIGHEST):
    """Planar IQ [..., m, n] -> power [..., m/2, n], radix-split DFTs.

    Equivalent to pipeline.stage01_04_mxu_planar (same math, factored
    operators); validated against it and the fp64 oracle in tests.
    """
    n = ops.doppler_plan.n
    # stage 01 window, range part (w_doppler applied before Doppler DFT)
    wr = jnp.asarray(ops.w_range)[:, None]
    xr = xr * wr
    xi = xi * wr
    # stage 02: forward range DFT, half-spectrum crop fused into the plan
    yr, yi = radix_dft_rows(xr, xi, ops.range_plan, precision)
    # stage 03a: Doppler window + mean subtraction over pulses.
    # Note conj is folded into the sign=+1 Doppler plan (see constants.py:
    # X5 = A X B with B = diag(wd) M conj(F_n) S Clip).
    wd = jnp.asarray(ops.w_doppler)
    yr = yr * wd
    yi = yi * wd
    yr = yr - jnp.mean(yr, axis=-1, keepdims=True)
    yi = yi - jnp.mean(yi, axis=-1, keepdims=True)
    # stage 03b: conjugated Doppler DFT
    zr, zi = radix_dft_cols(yr, yi, ops.doppler_plan, precision)
    # stage 03c: fftshift + clip the two highest post-shift bins
    zr = jnp.roll(zr, n // 2, axis=-1)
    zi = jnp.roll(zi, n // 2, axis=-1)
    zero = jnp.zeros_like(zr[..., :2])
    zr = jnp.concatenate([zr[..., : n - 2], zero], axis=-1)
    zi = jnp.concatenate([zi[..., : n - 2], zero], axis=-1)
    # stage 04
    return zr * zr + zi * zi
