"""The 11-stage polarimetric radar chain as compiled XLA programs.

Four interchangeable formulations, all pure functions over a batch of
sectors (jit once, vmap-free — every stage broadcasts over leading axes),
all validated against the fp64 oracle and the reference goldens:

* ``method="fft"``  — direct XLA formulation: window multiply, two batched
  ``jnp.fft.fft`` calls (cuFFT on the GPU), fused elementwise stages.
  Mirrors the reference chain stage-for-stage (read.cc:131-345) and
  produces every intermediate product for golden-parity tests.

* ``method="mxu"``  — the dense-matmul formulation: stages 01-04 are
  linear in the IQ matrix up to conjugation, so they collapse into two
  constant complex matmuls ``A_half @ X @ B`` (see
  constants.stage1_operators), followed by a 7-tap circular convolution
  and reductions.  The reference's own scratch experiment
  examples/matrixmul.cu:13-48 hints at the outer-product form.

* ``method="parseval"`` — the B matmul and conv collapse into a closed
  form by Parseval (constants.parseval_vectors); the A matmul runs in
  Gauss 3-multiply form.

* ``method="radix"`` — Cooley-Tukey split DFTs as XLA einsums
  (ops/dft.py).

``DEFAULT_METHOD`` is the formulation measured fastest on the GPU within
the oracle tolerance (PERF.md, route table); ``PRECISION_BY_PLATFORM``
names the dot precision each platform runs.  See DESIGN.md for the
derivations.

The matched filter (stages 05-07) is a circular convolution; we compute it
directly with 7 shifted fused multiply-adds instead of FFT->multiply->IFFT
(identical in exact arithmetic, cheaper and *more* accurate in fp32).  The
spectral form is kept as ``matched_filter_spectral`` for parity testing.

Dtype policy: complex64/float32 throughout — accuracy is the contract
(BASELINE.md).  Every dot names its precision explicitly, so none runs
in TF32 unless asked to.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import RadarConfig, DEFAULT_CONFIG
from .constants import PipelineConstants

Array = jax.Array


# --------------------------------------------------------------------------
# Stage ops (method="fft" path).  All take [..., m, n] and broadcast.
# --------------------------------------------------------------------------


def stage01_window(iq: Array, hamming: Array) -> Array:
    return iq * hamming


def stage02_range_fft(x: Array) -> Array:
    return jnp.fft.fft(x, axis=-2)


def stage03_doppler(x: Array) -> Array:
    n = x.shape[-1]
    mean = jnp.mean(x, axis=-1, keepdims=True)
    y = jnp.conj(x - mean)
    y = jnp.fft.fft(y, axis=-1)
    y = jnp.conj(jnp.roll(y, n // 2, axis=-1))
    return y.at[..., n - 2 :].set(0.0)


def stage04_power(x: Array) -> Array:
    m = x.shape[-2]
    half = x[..., : m // 2, :]
    return jnp.real(half) ** 2 + jnp.imag(half) ** 2


def matched_filter_direct(p: Array, ma_taps: Array) -> Array:
    """Stages 05-07 as an explicit circular convolution along the pulse
    axis: conv[j] = sum_k ma[k] * p[(j - k) mod n].  XLA fuses the 7
    roll+FMA passes into one elementwise sweep."""
    taps = np.asarray(ma_taps)
    out = taps[0] * p
    for k in range(1, taps.shape[0]):
        out = out + taps[k] * jnp.roll(p, k, axis=-1)
    return out


def matched_filter_spectral(p: Array, fft_ma: Array) -> Array:
    """Stages 05-07 in the reference's spectral form: forward FFT of the
    (real) power rows, pointwise multiply by the MA spectrum, inverse FFT,
    real part (read.cc:272-327; jnp.fft.ifft normalises by 1/n exactly like
    the reference's explicit /n after unnormalised FFTW BACKWARD)."""
    spec = jnp.fft.fft(p.astype(fft_ma.dtype), axis=-1) * fft_ma
    return jnp.fft.ifft(spec, axis=-1).real


def stage08_pulse_sum(conv: Array) -> Array:
    return jnp.sum(conv, axis=-1)


def stage09_10_products(pow_hh: Array, pow_vv: Array, gain: Array):
    zdb = 10.0 * log10(gain * pow_hh)
    # zdr as log of the power ratio, not difference of logs: identical in
    # exact arithmetic (read.cc:343) but far better conditioned in fp32 —
    # hh/vv are close, and subtracting two ~2e-6-absolute-error device logs
    # leaves a catastrophically cancelled small number.  inf/nan edge
    # semantics match: vv=0 -> +inf, hh=vv=0 -> nan either way.
    zdr = 10.0 * log10(pow_hh / pow_vv)
    return zdb, zdr


def log10(x: Array) -> Array:
    return jnp.log(x) / np.log(10.0)


# --------------------------------------------------------------------------
# Matmul path: stages 01-04 as two complex matmuls.
# --------------------------------------------------------------------------


def _rmatmul(ar, ai, br, bi, precision):
    """(ar+i*ai) @ (br+i*bi) via four real matmuls with controlled
    precision.  The explicit real decomposition makes the precision knob
    apply to every pass and keeps the device dataflow real-valued (the
    wire codec produces planar I/Q anyway)."""
    dot = functools.partial(jnp.matmul, precision=precision)
    return dot(ar, br) - dot(ai, bi), dot(ar, bi) + dot(ai, br)


def _rmatmul_gauss(ar, ai, asum, br, bi, precision):
    """Gauss/Karatsuba complex matmul: 3 real matmuls instead of 4.

    (ar + i ai)(br + i bi) with m1 = ar br, m2 = ai bi,
    m3 = (ar + ai)(br + bi); real = m1 - m2, imag = m3 - m1 - m2.
    `asum = ar + ai` is precomputed (the A operator is constant).  The
    m3 - m1 - m2 cancellation costs ~1 extra ulp; measured end-to-end
    accuracy is within 2x of the 4-pass form (tests/test_pipeline.py).
    """
    dot = functools.partial(jnp.matmul, precision=precision)
    m1 = dot(ar, br)
    m2 = dot(ai, bi)
    m3 = dot(asum, br + bi)
    return m1 - m2, m3 - m1 - m2


def stage_b_parseval(yr: Array, yi: Array, wd: Array, phasors: Array,
                     precision=jax.lax.Precision.HIGHEST) -> Array:
    """Stages 03b-08 in closed form (constants.parseval_vectors): the pulse
    sum of matched-filter power equals, by Parseval on the Doppler DFT,

        pow[i] = n * sum_j |q_ij - qbar_i|^2
                 - |q_i . f_k1|^2 - |q_i . f_k2|^2          (q = y * w_d)

    i.e. one fused elementwise sweep over Y plus a [*, n] @ [n, 4] skinny matmul
    for the two clipped Doppler bins — no [n, n] matmul, no conv pass.
    (sum(ma_taps) == 1 exactly, so the matched-filter fold factor is 1.)
    The mean is subtracted *before* the clip-bin dot products (f_k is
    orthogonal to the all-ones vector, so this is exact) to avoid
    catastrophic cancellation when the DC/clutter line dominates."""
    n = yr.shape[-1]
    qr = yr * wd
    qi = yi * wd
    qr = qr - jnp.mean(qr, axis=-1, keepdims=True)
    qi = qi - jnp.mean(qi, axis=-1, keepdims=True)
    s = n * jnp.sum(qr * qr + qi * qi, axis=-1)
    # d[..., 0:2] = q . (cos_k, sin_k) for k1; 2:4 for k2.
    dot = functools.partial(jnp.matmul, precision=precision)
    dr = dot(qr, phasors.T)             # [..., 4]
    di = dot(qi, phasors.T)
    # |q . f_k|^2 = (qr.c - qi.s)^2 + (qr.s + qi.c)^2
    for c, sn in ((0, 1), (2, 3)):
        re = dr[..., c] - di[..., sn]
        im = dr[..., sn] + di[..., c]
        s = s - (re * re + im * im)
    return s


def stage01_04_mxu_planar(xr: Array, xi: Array, op_a: tuple, op_b: tuple,
                          precision=jax.lax.Precision.HIGHEST) -> Array:
    """Planar IQ ([..., m, n] real, imag) -> power [..., m/2, n] via
    A_half @ X @ B, entirely in real float32 arithmetic.

    Folds window, range FFT, mean-subtraction, Doppler FFT, conj/fftshift,
    bin clipping and the half-spectrum crop into two constant matmuls.
    """
    ar, ai = op_a
    br, bi = op_b
    yr, yi = _rmatmul(ar, ai, xr, xi, precision)
    zr, zi = _rmatmul(yr, yi, br, bi, precision)
    return zr * zr + zi * zi


def stage01_04_mxu(iq: Array, op_a_half: Array, op_b: Array,
                   precision=jax.lax.Precision.HIGHEST) -> Array:
    """Complex-input convenience wrapper over stage01_04_mxu_planar."""
    return stage01_04_mxu_planar(
        jnp.real(iq), jnp.imag(iq),
        (jnp.real(op_a_half), jnp.imag(op_a_half)),
        (jnp.real(op_b), jnp.imag(op_b)),
        precision,
    )


# --------------------------------------------------------------------------
# Full chain.
# --------------------------------------------------------------------------


def channel_power_planar(
    xr: Array,
    xi: Array,
    consts: PipelineConstants,
    method: str = "mxu",
    matched_filter: str = "direct",
    precision=jax.lax.Precision.HIGHEST,
) -> Array:
    """Stages 01-08 on planar IQ: (real, imag) [..., m, n] -> pow [..., m/2].

    The planar form is the device-facing API: no complex arrays cross the
    host<->device boundary, and the mxu path never materialises complex at
    all (pure real dataflow)."""
    if method == "fft":
        x = jax.lax.complex(xr, xi)
        x = stage01_window(x, jnp.asarray(consts.hamming, xr.dtype))
        x = stage02_range_fft(x)
        x = stage03_doppler(x)
        p = stage04_power(x)
    elif method == "mxu":
        a, b = jnp.asarray(consts.op_a_half), jnp.asarray(consts.op_b)
        p = stage01_04_mxu_planar(
            xr, xi,
            (jnp.real(a), jnp.imag(a)),
            (jnp.real(b), jnp.imag(b)),
            precision,
        )
    elif method == "parseval":
        # Fastest path: Gauss 3-pass A matmul + closed-form stages 03b-08.
        # Implies the matched-filter fold (final products identical).
        ar = jnp.asarray(np.ascontiguousarray(consts.op_a_half.real))
        ai = jnp.asarray(np.ascontiguousarray(consts.op_a_half.imag))
        yr, yi = _rmatmul_gauss(ar, ai, ar + ai, xr, xi, precision)
        return stage_b_parseval(yr, yi, jnp.asarray(consts.wd),
                                jnp.asarray(consts.clip_phasors), precision)
    else:
        raise ValueError(f"unknown method {method!r}")

    if matched_filter == "direct":
        conv = matched_filter_direct(p, consts.ma_taps)
    elif matched_filter == "fold":
        # sum-preserving identity of the circular convolution; see
        # _power_planar_jit for the derivation and caveats.
        return stage08_pulse_sum(p) * float(np.sum(consts.ma_taps))
    elif matched_filter == "spectral":
        conv = matched_filter_spectral(p, jnp.asarray(consts.fft_ma))
    else:
        raise ValueError(f"unknown matched_filter {matched_filter!r}")
    return stage08_pulse_sum(conv)


def channel_power(
    iq: Array,
    consts: PipelineConstants,
    method: str = "mxu",
    matched_filter: str = "direct",
    precision=jax.lax.Precision.HIGHEST,
) -> Array:
    """Stages 01-08: IQ [..., m, n] complex64 -> pow [..., m/2] float32."""
    return channel_power_planar(
        jnp.real(iq), jnp.imag(iq), consts, method, matched_filter, precision
    )


def process_sectors_planar(
    iq_planar: Array,
    consts: PipelineConstants,
    method: str = "mxu",
    matched_filter: str = "direct",
    precision=jax.lax.Precision.HIGHEST,
) -> Tuple[Array, Array]:
    """Full chain on planar IQ [..., channels, 2, m, n] float32 (the codec's
    native layout, io/codec.decode_iq) -> (zdb, zdr) each [..., m/2]."""
    pow_all = channel_power_planar(
        iq_planar[..., 0, :, :], iq_planar[..., 1, :, :],
        consts, method, matched_filter, precision,
    )
    gain = jnp.asarray(consts.gain)
    return stage09_10_products(pow_all[..., 0, :], pow_all[..., 1, :], gain)


def process_sectors(
    iq: Array,
    consts: PipelineConstants,
    method: str = "mxu",
    matched_filter: str = "direct",
    precision=jax.lax.Precision.HIGHEST,
) -> Tuple[Array, Array]:
    """Full chain over a batch: IQ [..., channels, m, n] complex ->
    (zdb, zdr) each [..., m/2].  Channel 0 = hh, channel 1 = vv; extra
    channels (vh) ride along through the power stages like the reference
    (read_single.cc:485-502) so per-channel power is available."""
    pow_all = channel_power(iq, consts, method, matched_filter, precision)
    gain = jnp.asarray(consts.gain)
    return stage09_10_products(pow_all[..., 0, :], pow_all[..., 1, :], gain)


def all_stages(
    iq: Array, consts: PipelineConstants, matched_filter: str = "direct"
) -> Dict[str, Array]:
    """Every stage boundary of the fft path, keyed like the reference's
    golden files — the formalisation of its staged-dump test methodology."""
    out = {"00iq": iq}
    out["01hamm"] = stage01_window(iq, jnp.asarray(consts.hamming, iq.real.dtype))
    out["02fft1"] = stage02_range_fft(out["01hamm"])
    out["03fft2"] = stage03_doppler(out["02fft1"])
    out["04abs"] = stage04_power(out["03fft2"])
    if matched_filter == "direct":
        out["07conv"] = matched_filter_direct(out["04abs"], consts.ma_taps)
    else:
        out["07conv"] = matched_filter_spectral(out["04abs"], jnp.asarray(consts.fft_ma))
    out["08pow"] = stage08_pulse_sum(out["07conv"])
    zdb, zdr = stage09_10_products(
        out["08pow"][..., 0, :], out["08pow"][..., 1, :], jnp.asarray(consts.gain)
    )
    out["09zdb"], out["10zdr"] = zdb, zdr
    return out


# --------------------------------------------------------------------------
# Jitted entry points.
# --------------------------------------------------------------------------


#: Named dot-precision policies, each passed explicitly to every dot.
#: "highest" is full fp32; "bf16x3"/"bf16x6" split each fp32 operand
#: into bf16 parts and run 3 or 6 bf16 products with fp32 accumulation
#: (tensor cores on the GPU); "tf32" is one TF32 product, ~3 decimal
#: digits, kept only so the route table can show what it costs.
PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "bf16x3": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
    "bf16x6": jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X6,
    "tf32": jax.lax.DotAlgorithmPreset.TF32_TF32_F32,
}

#: The formulations SectorProcessor runs (module docstring).
METHODS = ("fft", "parseval", "radix", "mxu")

#: The flagship formulation: the fastest on the H100 that holds the
#: oracle tolerance (PERF.md, route table: cuFFT, exact fp32, no dots).
DEFAULT_METHOD = "fft"

#: Dot precision per platform, for the matmul formulations.  "gpu" is
#: the route table's choice: bf16x3 is the fastest precision that holds
#: the oracle limits for parseval, radix and mxu alike (tf32 fails
#: them); the CPU backend runs full fp32.  Any other platform is an
#: error, not a silent default.
PRECISION_BY_PLATFORM = {"gpu": "bf16x3", "cpu": "highest"}


def precision_for(platform: str | None = None) -> str:
    """The dot precision `platform` runs (default: JAX's default
    backend)."""
    platform = platform or jax.default_backend()
    try:
        return PRECISION_BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"no dot precision chosen for platform {platform!r}; known: "
            f"{sorted(PRECISION_BY_PLATFORM)}") from None


@functools.partial(
    jax.jit,
    static_argnames=("ma_taps_tuple", "method", "matched_filter", "precision"),
)
def _power_planar_jit(iq_planar, hamming, ma_taps_tuple, fft_ma,
                      op_ar, op_ai, op_br, op_bi, op_asum, wd, phasors,
                      method, matched_filter, precision="highest"):
    """Stages 01-08: planar IQ [..., C, 2, m, n] -> pow [..., C, m/2].
    int16 planar input (compact device feed) casts on-device."""
    xr = iq_planar[..., 0, :, :].astype(jnp.float32)
    xi = iq_planar[..., 1, :, :].astype(jnp.float32)
    if method == "parseval":
        prec = PRECISIONS[precision]
        yr, yi = _rmatmul_gauss(op_ar, op_ai, op_asum, xr, xi, prec)
        return stage_b_parseval(yr, yi, wd, phasors, prec)
    if method == "mxu":
        p = stage01_04_mxu_planar(xr, xi, (op_ar, op_ai), (op_br, op_bi),
                                  PRECISIONS[precision])
    elif method == "fft":
        x = jax.lax.complex(xr, xi)
        x = stage01_window(x, hamming)
        x = stage02_range_fft(x)
        x = stage03_doppler(x)
        p = stage04_power(x)
    else:
        raise ValueError(f"unknown method {method!r}")
    if matched_filter not in ("direct", "fold", "spectral"):
        raise ValueError(f"unknown matched_filter {matched_filter!r}")
    if matched_filter == "direct":
        conv = matched_filter_direct(p, np.asarray(ma_taps_tuple, np.float32))
        pow_all = stage08_pulse_sum(conv)
    elif matched_filter == "fold":
        # Stages 05-08 folded: circular convolution preserves row sums
        # exactly (sum_j (p (*) ma)[j] = sum_j p[j] * sum_k ma[k]), so the
        # pulse-sum of the matched-filter output equals the pulse-sum of
        # the power matrix scaled by sum(ma).  Identity tested to ~1e-8 in
        # fp32 (tests/test_pipeline.py); use "direct" when stage-07
        # intermediates must be materialised.
        pow_all = stage08_pulse_sum(p) * float(np.sum(ma_taps_tuple))
    else:
        # fft_ma is carried planar [2, n] (complex64 transfer is not
        # universally supported); rebuild complex on device.
        conv = matched_filter_spectral(p, jax.lax.complex(fft_ma[0], fft_ma[1]))
        pow_all = stage08_pulse_sum(conv)
    return pow_all


def to_planar(iq) -> np.ndarray:
    """Complex [..., m, n] -> planar float32 [..., 2, m, n] (host-side)."""
    if isinstance(iq, np.ndarray):
        return np.stack([iq.real.astype(np.float32),
                         iq.imag.astype(np.float32)], axis=-3)
    return jnp.stack([jnp.real(iq).astype(jnp.float32),
                      jnp.imag(iq).astype(jnp.float32)], axis=-3)


class SectorProcessor:
    """Compiled batch processor bound to one config + device placement.

    Accepts complex IQ [B, C, m, n] (split to planar host-side), planar
    IQ [B, C, 2, m, n] in float32 or int16 (the compact wire-native feed,
    cast on the device), or — with wire_input=True — raw reference wire
    bytes [B, sector_nbytes_wire] uint8, decoded on the device
    (ops/device_codec) inside the same jit.

    method: one of METHODS (module docstring); "radix" falls back to
    "mxu" when the geometry does not split.  precision: a PRECISIONS key,
    default precision_for() the device's platform.

    Usage::

        proc = SectorProcessor(cfg)
        zdb, zdr = proc(iq_batch)
    """

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        method: str = DEFAULT_METHOD,
        matched_filter: str = "direct",
        device=None,
        precision: str | None = None,
        wire_input: bool = False,
    ):
        """device: placement for the chain's constants; inputs follow."""
        if matched_filter not in ("direct", "fold", "spectral"):
            raise ValueError(
                f"unknown matched_filter {matched_filter!r}: use "
                "'direct', 'fold', or 'spectral'")
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}: use one of "
                             f"{METHODS}")
        if method == "radix" and matched_filter == "spectral":
            raise ValueError(
                "method='radix' implements 'direct' and 'fold' matched "
                "filters; use method='mxu' or 'fft' for the spectral "
                "parity path")
        self.precision = precision or precision_for(
            device.platform if device is not None else None)
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}: use "
                             f"one of {sorted(PRECISIONS)}")
        self.cfg = cfg
        self.wire_input = wire_input
        if method == "radix":
            from .ops.dft import RadixStageOperators

            if RadixStageOperators.supports(cfg):
                self._radix_ops = RadixStageOperators.build(cfg)
            else:
                method = "mxu"  # geometry too small to split
        self.method = method
        self.matched_filter = matched_filter
        self.device = device
        consts = PipelineConstants.build(cfg)
        put = functools.partial(jax.device_put, device=device)
        gain = put(consts.gain)
        if method == "radix":
            self._radix_fn = self._build_radix_fn(consts)
        else:
            self._dev_consts = (
                put(consts.hamming),
                tuple(float(t) for t in consts.ma_taps),  # static: in jit
                put(np.stack([consts.fft_ma.real, consts.fft_ma.imag]).astype(
                    np.float32)),
                put(np.ascontiguousarray(consts.op_a_half.real)),
                put(np.ascontiguousarray(consts.op_a_half.imag)),
                put(np.ascontiguousarray(consts.op_b.real)),
                put(np.ascontiguousarray(consts.op_b.imag)),
                put(np.ascontiguousarray(consts.op_a_half.real
                                         + consts.op_a_half.imag)),
                put(consts.wd),
                put(consts.clip_phasors),
            )

        def chain(iq_planar):
            pow_all = self.power(iq_planar)
            return stage09_10_products(pow_all[..., 0, :],
                                       pow_all[..., 1, :], gain)

        self._chain = jax.jit(chain)
        if wire_input:
            from .ops.device_codec import decode_wire_i16

            self._wire_fn = jax.jit(
                lambda wire: chain(decode_wire_i16(wire, cfg)))

    def _build_radix_fn(self, consts: PipelineConstants):
        """Per-instance jit for the radix method (its operator tables are
        embedded as XLA constants — a few hundred KB)."""
        from .ops.dft import stage01_04_radix

        ops = self._radix_ops
        taps = consts.ma_taps.copy()
        prec = PRECISIONS[self.precision]

        matched_filter = self.matched_filter

        @jax.jit
        def fn(iq_planar):
            p = stage01_04_radix(
                iq_planar[..., 0, :, :].astype(jnp.float32),
                iq_planar[..., 1, :, :].astype(jnp.float32), ops, prec)
            if matched_filter == "fold":
                return stage08_pulse_sum(p) * float(np.sum(taps))
            return stage08_pulse_sum(matched_filter_direct(p, taps))

        return fn

    def power(self, iq_planar):
        """Stages 01-08 on planar IQ [..., C, 2, m, n] (float32 or int16)
        -> per-channel pulse-summed power [..., C, m/2], on the device."""
        if self.method == "radix":
            return self._radix_fn(iq_planar)
        h, taps, fm, ar, ai, br, bi, asum, wd, ph = self._dev_consts
        return _power_planar_jit(iq_planar, h, taps, fm, ar, ai, br, bi,
                                 asum, wd, ph,
                                 self.method, self.matched_filter,
                                 self.precision)

    def lower(self, batch: int, dtype=np.int16):
        """The jitted chain lowered for a [batch, C, 2, m, n] planar input
        of `dtype` (or [batch, sector_nbytes_wire] uint8 with
        wire_input): `.compile().memory_analysis()` says what a step of
        that size needs on the device."""
        if self.wire_input:
            spec = jax.ShapeDtypeStruct(
                (batch, self.cfg.sector_nbytes_wire), np.uint8)
            return self._wire_fn.lower(spec)
        c, m, n = self.cfg.sector_shape
        return self._chain.lower(
            jax.ShapeDtypeStruct((batch, c, 2, m, n), dtype))

    def __call__(self, iq: Array) -> Tuple[Array, Array]:
        if self.wire_input:
            nb = self.cfg.sector_nbytes_wire
            if (np.iscomplexobj(iq) or iq.dtype != np.uint8
                    or iq.shape[-1] != nb):
                raise ValueError(
                    f"wire_input processor expects uint8 [..., {nb}] raw "
                    f"wire bytes; got {iq.dtype} {tuple(iq.shape)}")
            if iq.ndim == 1:
                zdb, zdr = self._wire_fn(iq[None])
                return zdb[0], zdr[0]
            return self._wire_fn(iq)
        if np.iscomplexobj(iq):
            iq = to_planar(np.asarray(iq) if isinstance(iq, np.ndarray) else iq)
        expect = (self.cfg.num_channels, 2, self.cfg.m, self.cfg.n)
        if tuple(iq.shape[-4:]) != expect:
            raise ValueError(
                f"planar IQ must end in [channels, 2, m, n] = {expect}, "
                f"got {tuple(iq.shape)}"
            )
        if iq.ndim == 4:
            # unbatched single sector: normalise to an explicit batch
            # axis so every method sees the same rank
            zdb, zdr = self._chain(iq[None])
            return zdb[0], zdr[0]
        return self._chain(iq)
