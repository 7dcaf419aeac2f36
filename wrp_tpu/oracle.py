"""Float64 numpy oracle for the 11-stage chain.

This is the in-repo ground truth, semantically equivalent to the reference
fp64 CPU pipeline (/root/reference/read.cc:131-345).  It exists because the
reference's staged golden inputs for stages 00-03 are missing
(.MISSING_LARGE_BLOBS), so full-chain validation of the device pipelines runs
against this oracle on synthetic IQ, while stages 05-09 are additionally
pinned to the committed golden files (in/04abs.altb -> out/08pow.cpu.out ->
in/09zdb.altb).

Everything is written stage-by-stage so tests can compare at every stage
boundary, exactly like the reference's artisanal golden-file methodology
(SURVEY.md section 4).
"""

from __future__ import annotations

import numpy as np

from .config import RadarConfig, DEFAULT_CONFIG
from . import constants as C


# --------------------------------------------------------------------------
# Stage functions.  Input IQ is [..., m, n] complex128 (leading dims free,
# e.g. [channel, m, n]); all stages broadcast over leading axes.
# --------------------------------------------------------------------------


def stage01_window(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Hamming window multiply (read.cc:134-148)."""
    return iq * C.hamming_coefficients(cfg)


def stage02_range_fft(x: np.ndarray) -> np.ndarray:
    """Forward FFT along the range axis (axis -2), one per pulse column
    (read.cc:150-183)."""
    return np.fft.fft(x, axis=-2)


def stage03_doppler(x: np.ndarray) -> np.ndarray:
    """Mean-subtract + conjugate, Doppler FFT, conjugate + fftshift, clip
    the two highest post-shift bins (read.cc:185-256)."""
    n = x.shape[-1]
    mean = x.mean(axis=-1, keepdims=True)
    y = np.conj(x - mean)
    y = np.fft.fft(y, axis=-1)
    y = np.conj(np.roll(y, n // 2, axis=-1))
    y[..., n - 2 :] = 0.0
    return y


def stage04_power(x: np.ndarray) -> np.ndarray:
    """|.|^2 of the first m/2 range rows (read.cc:281-288)."""
    m = x.shape[-2]
    half = x[..., : m // 2, :]
    return half.real**2 + half.imag**2


def stage05_07_matched_filter(
    p: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """FFT -> multiply by MA spectrum -> unnormalised IFFT / n, real part
    (read.cc:272-327).  Mathematically a circular convolution with the
    7-tap Gaussian along the pulse axis."""
    spec = np.fft.fft(p.astype(np.complex128), axis=-1) * C.ma_spectrum(cfg)
    # np.fft.ifft normalises by 1/n, matching the explicit /n of the
    # unnormalised FFTW BACKWARD transform (read.cc:297-301).
    return np.fft.ifft(spec, axis=-1).real


def stage08_pulse_sum(conv: np.ndarray) -> np.ndarray:
    """Sum over the pulse axis per range cell (read.cc:335-339)."""
    return conv.sum(axis=-1)


def stage09_10_products(
    pow_hh: np.ndarray, pow_vv: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
):
    """Reflectivity zdb and differential reflectivity zdr (read.cc:341-343).

    Bin 0 carries zero range gain, so zdb[0] = -inf by construction; the
    comparator skips non-finite values (error.cpp:19-31)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        z = C.range_gain(cfg) * pow_hh
        zdb = 10.0 * np.log10(z)
        zdr = 10.0 * (np.log10(pow_hh) - np.log10(pow_vv))
    return zdb, zdr


# --------------------------------------------------------------------------
# Full chain.
# --------------------------------------------------------------------------


def channel_power(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Stages 01-08 for one or more channels: IQ [..., m, n] -> pow [..., m/2]."""
    x = stage01_window(np.asarray(iq, np.complex128), cfg)
    x = stage02_range_fft(x)
    x = stage03_doppler(x)
    p = stage04_power(x)
    conv = stage05_07_matched_filter(p, cfg)
    return stage08_pulse_sum(conv)


def process_sector(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG):
    """Full chain: IQ [channels, m, n] -> (zdb [m/2], zdr [m/2]).

    Channel 0 is hh, channel 1 is vv; additional channels (vh) are processed
    but unused in the products, matching read_single.cc:485-502."""
    pow_all = channel_power(iq, cfg)
    return stage09_10_products(pow_all[0], pow_all[1], cfg)


def all_stages(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> dict:
    """Every stage boundary, keyed by the reference's golden-file names."""
    out = {"00iq": np.asarray(iq, np.complex128)}
    out["01hamm"] = stage01_window(out["00iq"], cfg)
    out["02fft1"] = stage02_range_fft(out["01hamm"])
    out["03fft2"] = stage03_doppler(out["02fft1"])
    out["04abs"] = stage04_power(out["03fft2"])
    out["07conv"] = stage05_07_matched_filter(out["04abs"], cfg)
    out["08pow"] = stage08_pulse_sum(out["07conv"])
    zdb, zdr = stage09_10_products(out["08pow"][..., 0, :], out["08pow"][..., 1, :], cfg)
    out["09zdb"], out["10zdr"] = zdb, zdr
    return out


# --------------------------------------------------------------------------
# The reference's acceptance metric.
# --------------------------------------------------------------------------


def relative_l2(expected: np.ndarray, actual: np.ndarray) -> float:
    """sqrt(sum((ue-uc)^2) / sum(ue^2)) over mutually finite entries
    (error.cpp:9-36)."""
    e = np.asarray(expected, np.float64).ravel()
    a = np.asarray(actual, np.float64).ravel()
    mask = np.isfinite(e) & np.isfinite(a)
    if e.size and not mask.any():
        # nothing is mutually comparable (e.g. an all-NaN pipeline
        # output): that is a FAILURE, not a vacuous pass — returning 0.0
        # here would let a completely broken result through `cli
        # compare` and every parity gate built on this metric
        return float("inf")
    denom = np.sum(e[mask] ** 2)
    if denom == 0.0:
        return float(np.sqrt(np.sum((e[mask] - a[mask]) ** 2)))
    return float(np.sqrt(np.sum((e[mask] - a[mask]) ** 2) / denom))


def produce_sector_iq(cfg: RadarConfig, seed: int, k: int) -> np.ndarray:
    """The IQ matrix `cli produce --per-sector-seed SEED` (and its
    `--pool` replay entries) puts on the wire for global sector index k
    — derived from (seed, k) alone, so a verifier recomputes exactly
    what the producer sent without replaying the stream
    (tools/consolidation_soak.py contamination checks)."""
    rng = np.random.default_rng((seed, k))
    return (rng.integers(-8192, 8192, cfg.sector_shape)
            + 1j * rng.integers(-8192, 8192, cfg.sector_shape))


def synthetic_iq(
    cfg: RadarConfig = DEFAULT_CONFIG, kind: str = "ramp", seed: int = 0
) -> np.ndarray:
    """Deterministic synthetic sector IQ, [channels, m, n] complex.

    kind="ramp" mirrors the reference's synthetic determinism inputs
    make_cuFloatComplex(i, j) / (j, i) (gpu_1fp.cu:295-312); "noise" is
    scaled white noise in the 14-bit ADC range.
    """
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if kind == "ramp":
        i = np.arange(m)[:, None] * np.ones((1, n))
        j = np.ones((m, 1)) * np.arange(n)[None, :]
        base = np.stack([i + 1j * j, j + 1j * i, (i - j) + 1j * (i + j)])
        return base[:ch].astype(np.complex128)
    if kind == "noise":
        rng = np.random.default_rng(seed)
        re = rng.integers(-8192, 8192, size=(ch, m, n))
        im = rng.integers(-8192, 8192, size=(ch, m, n))
        return (re + 1j * im).astype(np.complex128)
    raise ValueError(f"unknown synthetic kind: {kind}")


def adversarial_clip_iq(cfg: RadarConfig = DEFAULT_CONFIG,
                        seed: int = 0) -> np.ndarray:
    """Integer IQ [channels, m, n] whose Doppler energy sits in the
    CLIPPED bins (pre-shift k = n/2 - 2) over small noise.  The Parseval
    closed form n*sum|q|^2 - |clip|^2 then cancels catastrophically, and
    any dot run below fp32 precision on the clip-bin phasors shows up in
    the power (compare channel power, not the log-domain products)."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    rng = np.random.default_rng(seed)
    _, wd, _ = C.hamming_factors(cfg)
    j = np.arange(n)
    k = n // 2 - 2
    ph0 = rng.uniform(0, 2 * np.pi, (ch, m, 1))
    base = np.cos(2 * np.pi * k * j / n + ph0) / wd[None, None, :]
    adv = (6000 * base / np.abs(base).max()
           + 1j * rng.integers(-50, 50, (ch, m, n)))
    return np.round(adv.real) + 1j * np.round(adv.imag)

