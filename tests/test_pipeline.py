"""JAX pipeline (both methods) vs the fp64 oracle on synthetic IQ.

This is the full-chain stage-00-10 validation the reference could not do
(its 00iq..03fft2 goldens are lost); the oracle is the in-repo ground truth
(oracle.py), pinned to the surviving goldens by test_golden.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from wrp_tpu import oracle, pipeline
from wrp_tpu.config import DEFAULT_CONFIG, tiny_config
from wrp_tpu.constants import PipelineConstants

FP32_CHAIN_BOUND = 2e-4  # full chain incl. two FFTs & big reductions in fp32


@pytest.fixture(scope="module")
def full_cfg_data():
    cfg = DEFAULT_CONFIG
    iq = oracle.synthetic_iq(cfg, kind="noise", seed=7)
    stages = oracle.all_stages(iq, cfg)
    return cfg, iq, stages


@pytest.mark.parametrize("method", ["fft", "mxu"])
def test_full_chain_vs_oracle(full_cfg_data, method):
    cfg, iq, stages = full_cfg_data
    proc = pipeline.SectorProcessor(cfg, method=method)
    zdb, zdr = proc(jnp.asarray(iq[None], jnp.complex64))
    zdb, zdr = np.asarray(zdb[0]), np.asarray(zdr[0])
    assert oracle.relative_l2(stages["09zdb"], zdb) < FP32_CHAIN_BOUND
    assert oracle.relative_l2(stages["10zdr"], zdr) < FP32_CHAIN_BOUND


def test_all_stages_vs_oracle(full_cfg_data):
    cfg, iq, stages = full_cfg_data
    consts = PipelineConstants.build(cfg)
    jax_stages = pipeline.all_stages(jnp.asarray(iq, jnp.complex64), consts)
    for name, bound in [
        ("01hamm", 1e-6),
        ("02fft1", 1e-5),
        ("03fft2", 1e-5),
        ("04abs", 5e-5),
        ("07conv", 5e-5),
        ("08pow", 1e-4),
    ]:
        got = np.asarray(jax_stages[name])
        want = stages[name]
        if np.iscomplexobj(want):
            err = oracle.relative_l2(
                np.stack([want.real, want.imag]), np.stack([got.real, got.imag])
            )
        else:
            err = oracle.relative_l2(want, got)
        assert err < bound, f"stage {name}: rel L2 {err} > {bound}"


def test_mxu_stage_equals_fft_stage(full_cfg_data):
    """The collapsed matmul form must reproduce stages 01-04 of the fft
    path (the algebraic identity behind the MXU formulation)."""
    cfg, iq, _ = full_cfg_data
    consts = PipelineConstants.build(cfg)
    x = jnp.asarray(iq, jnp.complex64)
    p_fft = pipeline.stage04_power(
        pipeline.stage03_doppler(
            pipeline.stage02_range_fft(
                pipeline.stage01_window(x, jnp.asarray(consts.hamming))
            )
        )
    )
    p_mxu = pipeline.stage01_04_mxu(
        x, jnp.asarray(consts.op_a_half), jnp.asarray(consts.op_b)
    )
    err = oracle.relative_l2(np.asarray(p_fft), np.asarray(p_mxu))
    assert err < 5e-5, err


@pytest.mark.parametrize("method", ["fft", "mxu"])
def test_batch_consistency(method):
    """Batched processing must equal per-sector processing bit-for-bit."""
    cfg = tiny_config(m=128, n=64)
    rng = np.random.default_rng(3)
    iq = (
        rng.integers(-2048, 2048, (4, cfg.num_channels, cfg.m, cfg.n))
        + 1j * rng.integers(-2048, 2048, (4, cfg.num_channels, cfg.m, cfg.n))
    ).astype(np.complex64)
    proc = pipeline.SectorProcessor(cfg, method=method)
    zdb_b, zdr_b = proc(jnp.asarray(iq))
    for k in range(4):
        zdb1, zdr1 = proc(jnp.asarray(iq[k : k + 1]))
        np.testing.assert_array_equal(np.asarray(zdb_b[k]), np.asarray(zdb1[0]))
        np.testing.assert_array_equal(np.asarray(zdr_b[k]), np.asarray(zdr1[0]))


def test_determinism_ramp():
    """Reference-style synthetic-ramp determinism (gpu_1fp.cu:295-312):
    same input twice -> identical outputs."""
    cfg = tiny_config(m=128, n=64)
    iq = oracle.synthetic_iq(cfg, kind="ramp")[None].astype(np.complex64)
    proc = pipeline.SectorProcessor(cfg, method="mxu")
    a = proc(jnp.asarray(iq))
    b = proc(jnp.asarray(iq))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_vh_channel_rides_along(full_cfg_data):
    """3-channel input processes channel 2 (vh) through the power stages but
    products depend only on hh/vv (read_single.cc:485-502)."""
    cfg, iq, _ = full_cfg_data
    consts = PipelineConstants.build(cfg)
    x = jnp.asarray(iq, jnp.complex64)
    pow_all = pipeline.channel_power(x, consts, method="mxu")
    assert pow_all.shape == (3, cfg.num_output_bins)
    # mutate vh; zdb/zdr unchanged
    x2 = x.at[2].multiply(3.0)
    z1 = pipeline.process_sectors(x, consts, method="mxu")
    z2 = pipeline.process_sectors(x2, consts, method="mxu")
    np.testing.assert_array_equal(np.asarray(z1[0]), np.asarray(z2[0]))
    np.testing.assert_array_equal(np.asarray(z1[1]), np.asarray(z2[1]))


def test_parseval_method_vs_oracle(full_cfg_data):
    """method="parseval": Gauss 3-pass A matmul + closed-form stages 03b-08
    must match the fp64 oracle's final products like every other method."""
    cfg, iq, stages = full_cfg_data
    proc = pipeline.SectorProcessor(cfg, method="parseval")
    zdb, zdr = proc(jnp.asarray(iq[None], jnp.complex64))
    zdb, zdr = np.asarray(zdb[0]), np.asarray(zdr[0])
    assert oracle.relative_l2(stages["09zdb"], zdb) < FP32_CHAIN_BOUND
    assert oracle.relative_l2(stages["10zdr"], zdr) < FP32_CHAIN_BOUND


def test_parseval_identity_exact_in_fp64():
    """The Parseval stage-B collapse is an exact algebraic identity
    (constants.parseval_vectors docstring), incl. a dominant DC line."""
    from wrp_tpu.constants import stage1_operators, parseval_vectors

    cfg = tiny_config(m=64, n=32)
    n = cfg.num_pulses
    A, B = stage1_operators(cfg, half=True)
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(cfg.m, n)) + 1j * rng.normal(size=(cfg.m, n))
         + 50.0)  # big DC offset stresses the cancellation path
    Y = A @ X
    want = np.sum(np.abs(Y @ B) ** 2, axis=-1)

    wd, phasors = parseval_vectors(cfg)
    q = Y * wd[None, :]
    q = q - q.mean(axis=-1, keepdims=True)
    got = n * np.sum(np.abs(q) ** 2, axis=-1)
    for c, s in ((0, 1), (2, 3)):
        d = q @ (phasors[c] + 1j * phasors[s])
        got = got - np.abs(d) ** 2
    assert oracle.relative_l2(want, got) < 1e-12


def test_parseval_matches_mxu_fold():
    """parseval == mxu+fold on random planar batches (fp32, CPU)."""
    cfg = tiny_config(m=64, n=32)
    rng = np.random.default_rng(11)
    planar = rng.integers(
        -8192, 8192, (3, cfg.num_channels, 2, cfg.m, cfg.n)
    ).astype(np.float32)
    a = pipeline.SectorProcessor(cfg, method="mxu", matched_filter="fold")
    b = pipeline.SectorProcessor(cfg, method="parseval")
    za, _ = a(planar)
    zb, _ = b(planar)
    za, zb = np.asarray(za), np.asarray(zb)
    fin = np.isfinite(za) & np.isfinite(zb)
    assert oracle.relative_l2(za[fin], zb[fin]) < 2e-5


@pytest.mark.parametrize("m,n,channels", [
    (32, 16, 2),    # minimum-ish geometry, 2-channel
    (64, 48, 3),    # n not a power of two (DFT-as-matmul doesn't care)
    (128, 64, 3),   # radix-8-eligible m
    (96, 32, 3),    # m with a non-dyadic factor (radix falls back)
])
def test_geometry_sweep_all_methods(m, n, channels):
    """Every compute path handles non-default geometries and agrees with
    the fp64 oracle (the reference hardcodes one geometry; configurability
    is a framework requirement, config.py docstring)."""
    cfg = tiny_config(m=m, n=n, channels=channels)
    iq = oracle.synthetic_iq(cfg, kind="noise", seed=m + n)
    zdb64, zdr64 = oracle.process_sector(iq, cfg)
    for method in pipeline.METHODS:
        proc = pipeline.SectorProcessor(cfg, method=method)
        zdb, zdr = proc(jnp.asarray(iq[None], jnp.complex64))
        err = oracle.relative_l2(zdb64, np.asarray(zdb)[0])
        assert err < 2e-4, (method, m, n, channels, err)
        err_zdr = oracle.relative_l2(zdr64, np.asarray(zdr)[0])
        assert err_zdr < 5e-4, ("zdr", method, m, n, channels, err_zdr)


def test_matched_filter_validation_and_unsupported_combos():
    """Unknown or unsupported matched_filter values must raise at
    construction, never silently run a different formulation."""
    import pytest

    from wrp_tpu.config import tiny_config
    from wrp_tpu.pipeline import SectorProcessor

    cfg = tiny_config(m=32, n=16)
    with pytest.raises(ValueError):
        SectorProcessor(cfg, method="mxu", matched_filter="folded")  # typo
    with pytest.raises(ValueError):
        SectorProcessor(cfg, method="radix", matched_filter="spectral")
    with pytest.raises(ValueError, match="unknown method"):
        SectorProcessor(cfg, method="pallas")      # removed, not aliased


def test_unbatched_planar_input_consistent_across_methods():
    """A single decoded sector [C, 2, m, n] (no batch axis) must work on
    every method and give the same answer as the batched call."""
    import numpy as np

    from wrp_tpu import oracle
    from wrp_tpu.config import tiny_config
    from wrp_tpu.pipeline import SectorProcessor, to_planar

    cfg = tiny_config(m=32, n=16)
    iq = oracle.synthetic_iq(cfg, kind="noise", seed=7)
    planar = to_planar(np.asarray(iq, np.complex64))
    for method in ("mxu", pipeline.DEFAULT_METHOD):
        proc = SectorProcessor(cfg, method=method)
        zdb_b, _ = proc(planar[None])
        zdb_u, _ = proc(planar)
        np.testing.assert_array_equal(np.asarray(zdb_b)[0],
                                      np.asarray(zdb_u))


def test_relative_l2_all_nonfinite_is_a_failure():
    """An all-NaN actual must FAIL the metric (inf), not vacuously pass
    with 0.0 — cli compare and every parity gate rely on this."""
    import numpy as np

    from wrp_tpu import oracle

    e = np.linspace(1, 10, 16)
    assert oracle.relative_l2(e, np.full(16, np.nan)) == np.inf
    assert oracle.relative_l2(np.array([]), np.array([])) == 0.0
    # arrays with SOME mutually finite entries keep the usual semantics
    a = e.copy()
    a[0] = np.nan
    assert oracle.relative_l2(e, a) == 0.0
