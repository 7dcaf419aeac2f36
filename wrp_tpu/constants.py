"""Precomputed pipeline constants: window, matched filter, DFT operators.

Formulas reproduce the reference generators exactly:
  * Hamming window + normalisation  -> /root/reference/read.cc:9-38
  * 7-tap Gaussian moving average   -> /root/reference/read.cc:40-51
  * MA spectrum (zero-padded FFT)   -> /root/reference/read.cc:86-98

All constants are generated in float64 and cast at the edge, so the fp32
pipeline inherits fp64-accurate coefficients (the reference's fp32 builds
recompute them in fp32; our way is strictly more accurate and well inside
the SNR bound used for acceptance).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from .config import RadarConfig


def hamming_vector(length: int) -> np.ndarray:
    """Un-normalised reference Hamming window, w(x) = 0.53836 - 0.46164 cos(2 pi x/(L-1)).

    Note the non-standard 0.53836/0.46164 coefficients (read.cc:14)."""
    x = np.arange(length, dtype=np.float64)
    return 0.53836 - 0.46164 * np.cos(2.0 * np.pi * x / (length - 1))


def hamming_coefficients(cfg: RadarConfig) -> np.ndarray:
    """[m, n] separable window including the power-normalisation constant.

    c = K_wind / sqrt(p_range * p_doppler) with
    K_wind = -1 / (adc_scale * m * n * sqrt(impedance))   (read.cc:26-27).
    Returned as the full outer-product matrix like the reference; the
    separable factors are available via `hamming_factors` for the matmul path.
    """
    wr, wd, c = hamming_factors(cfg)
    return np.outer(wr, wd) * c


def hamming_factors(cfg: RadarConfig):
    """Separable factors (w_range[m], w_doppler[n], scalar c) of the window."""
    m, n = cfg.num_range_cells, cfg.num_pulses
    wr = hamming_vector(m)
    wd = hamming_vector(n)
    p_range = np.mean(wr**2)
    p_doppler = np.mean(wd**2)
    k_wind = -1.0 / (cfg.adc_scale * m * n * np.sqrt(cfg.impedance))
    c = k_wind / np.sqrt(p_range * p_doppler)
    return wr, wd, c


def ma_coefficients(cfg: RadarConfig) -> np.ndarray:
    """Gaussian moving-average taps, normalised to sum 1 (read.cc:40-51)."""
    k = cfg.ma_count
    i = np.arange(k, dtype=np.float64)
    # Integer division in the reference: (n-1)/2 with int n (read.cc:44).
    centre = (k - 1) // 2
    w = np.exp(-((i - centre) ** 2) / 2.0)
    return w / w.sum()


def ma_spectrum(cfg: RadarConfig) -> np.ndarray:
    """FFT of the zero-padded MA taps, length n (read.cc:86-98)."""
    taps = np.zeros(cfg.num_pulses, dtype=np.float64)
    taps[: cfg.ma_count] = ma_coefficients(cfg)
    return np.fft.fft(taps)


def range_gain(cfg: RadarConfig) -> np.ndarray:
    """(i * range_resolution)^2 * calibration per output bin (read.cc:341)."""
    i = np.arange(cfg.num_output_bins, dtype=np.float64)
    return (i * cfg.range_resolution) ** 2 * cfg.calibration


# ---------------------------------------------------------------------------
# DFT-as-matmul operators.
#
# Stages 01-03 of the chain are linear in the IQ matrix X[m, n] up to one
# complex conjugation, so they fold into two constant matmuls:
#
#   stage01  X1 = diag(w_r * c) X diag(w_d)            (window)
#   stage02  X2 = F_m X1                               (range FFT, axis 0)
#   stage03a X3 = conj(X2 (I - J/n))                   (mean-subtract + conj)
#   stage03b X4 = X3 F_n                               (Doppler FFT, axis 1;
#                                                       F_n symmetric)
#   stage03c X5 = conj(X4) P_shift M_clip              (conj + fftshift + clip)
#
# Collapsing the two conjugations (conj is an involution and distributes
# over matmul with conj of the constants):
#
#   X5 = (F_m diag(w_r * c)) X (diag(w_d) (I - J/n) conj(F_n) P M)
#      =        A            X                 B
#
# A is [m, m], B is [n, n], both complex128-generated then cast.  The
# product path additionally only needs the first m/2 rows of A (stage 04
# keeps the first half of the range spectrum, read.cc:281).
# ---------------------------------------------------------------------------


def dft_matrix(length: int, inverse: bool = False) -> np.ndarray:
    """Unnormalised DFT matrix F[j, k] = exp(-2 pi i j k / L) (conj if inverse)."""
    j = np.arange(length)
    sign = 2.0j if inverse else -2.0j
    return np.exp(sign * np.pi * np.outer(j, j) / length)


def stage1_operators(cfg: RadarConfig, half: bool = False):
    """(A, B) such that stages 01-03 == A @ X @ B.

    half=True returns only the first m/2 rows of A (fused stage-04 crop).
    """
    m, n = cfg.num_range_cells, cfg.num_pulses
    wr, wd, c = hamming_factors(cfg)

    A = dft_matrix(m) * (wr * c)[None, :]          # F_m @ diag(wr*c)
    if half:
        A = A[: m // 2]

    mean_sub = np.eye(n) - np.full((n, n), 1.0 / n)
    B = (wd[:, None] * mean_sub) @ np.conj(dft_matrix(n))
    # fftshift along columns = column permutation; clip zeroes the two
    # highest post-shift columns (read.cc:212-224).
    B = np.roll(B, n // 2, axis=1)
    B[:, n - 2 :] = 0.0
    return A, B


def parseval_vectors(cfg: RadarConfig):
    """Constants for the Parseval form of stages 03b-08 (pipeline method
    "parseval"): the final products only need the pulse-summed power
    sum_j |(Y B)[i, j]|^2, and B = diag(w_d) (I - J/n) conj(F_n) P M is a
    windowed mean-subtracting DFT with two clipped bins, so by Parseval

        pow[i] = n * sum_j |q_ij - qbar_i|^2 - |q_i . f_k1|^2 - |q_i . f_k2|^2

    with q = Y row * w_d, and f_k[j] = exp(2 pi i j k / n) the two DFT
    columns (k = n/2-2, n/2-1) that the post-fftshift clip removes
    (read.cc:212-224).  Exact in exact arithmetic (validated to 2e-14 in
    fp64, tests/test_pipeline.py); eliminates the [n, n] Doppler matmul.

    Returns (w_d [n] float64, phasors [4, n] float64) where phasors rows
    are (cos k1, sin k1, cos k2, sin k2).
    """
    n = cfg.num_pulses
    _, wd, _ = hamming_factors(cfg)
    j = np.arange(n, dtype=np.float64)
    rows = []
    for k in (n // 2 - 2, n // 2 - 1):
        ang = 2.0 * np.pi * j * k / n
        rows += [np.cos(ang), np.sin(ang)]
    return wd, np.stack(rows)


# ---------------------------------------------------------------------------
# Bundled constants object handed to the pipelines.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineConstants:
    """Everything `pipeline.process_*` needs, as numpy (device-put by caller)."""

    hamming: np.ndarray        # [m, n] float
    ma_taps: np.ndarray        # [ma_count] float
    fft_ma: np.ndarray         # [n] complex
    gain: np.ndarray           # [m/2] float (stage 09 range gain)
    op_a_half: np.ndarray      # [m/2, m] complex  (matmul path)
    op_b: np.ndarray           # [n, n] complex    (matmul path)
    wd: np.ndarray             # [n] float         (parseval path)
    clip_phasors: np.ndarray   # [4, n] float      (parseval path)

    @classmethod
    def build(cls, cfg: RadarConfig, dtype=np.float32) -> "PipelineConstants":
        cdtype = np.complex64 if dtype == np.float32 else np.complex128
        a_half, b = stage1_operators(cfg, half=True)
        wd, phasors = parseval_vectors(cfg)
        return cls(
            hamming=hamming_coefficients(cfg).astype(dtype),
            ma_taps=ma_coefficients(cfg).astype(dtype),
            fft_ma=ma_spectrum(cfg).astype(cdtype),
            gain=range_gain(cfg).astype(dtype),
            op_a_half=a_half.astype(cdtype),
            op_b=b.astype(cdtype),
            wd=wd.astype(dtype),
            clip_phasors=phasors.astype(dtype),
        )


@lru_cache(maxsize=8)
def default_constants(cfg: RadarConfig = None) -> PipelineConstants:
    from .config import DEFAULT_CONFIG

    return PipelineConstants.build(cfg or DEFAULT_CONFIG)
