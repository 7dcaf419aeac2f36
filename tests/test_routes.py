"""Every kept route against the fp64 oracle at small geometries: each
formulation x {2, 3} channels x {f32, i16, wire} input, the adversarial
clip-bin field, the per-platform dot-precision table, and the rule that
every dot names its precision."""

import jax
import numpy as np
import pytest

from wrp_tpu import oracle, pipeline
from wrp_tpu.config import tiny_config
from wrp_tpu.io import codec
from wrp_tpu.parity import LIMITS, route_parity
from wrp_tpu.pipeline import METHODS, SectorProcessor, to_planar

#: the smallest geometry every formulation runs without falling back
#: (radix needs m and n split by 128 into an even/>=2 factor)
M = N = 256


def _cfg(channels):
    return tiny_config(m=M, n=N, channels=channels)


@pytest.mark.parametrize("feed", ["f32", "i16", "wire"])
@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_route_vs_oracle(method, channels, feed):
    cfg = _cfg(channels)
    iq = [oracle.produce_sector_iq(cfg, 5, k) for k in range(2)]
    wires = [codec.encode_iq(x, cfg) for x in iq]
    proc = SectorProcessor(cfg, method=method, wire_input=feed == "wire")
    assert proc.method == method          # no silent fallback here
    if feed == "wire":
        x = np.stack([np.frombuffer(w, np.uint8) for w in wires])
    elif feed == "i16":
        x = np.stack([codec.decode_iq_i16(w, cfg) for w in wires])
    else:
        x = np.stack([codec.decode_iq(w, cfg) for w in wires])
    zdb, zdr = (np.asarray(a) for a in proc(x))
    assert zdb.shape == zdr.shape == (2, cfg.num_output_bins)
    for k in range(2):
        zdb64, zdr64 = oracle.process_sector(iq[k], cfg)
        assert oracle.relative_l2(zdb64, zdb[k]) < LIMITS["zdb"]
        assert oracle.relative_l2(zdr64, zdr[k]) < LIMITS["zdr"]


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_route_adversarial_clip_bin(method, channels):
    """Doppler energy in the clipped bins makes the Parseval closed form
    cancel catastrophically; channel power must still hold 2e-5."""
    cfg = _cfg(channels)
    adv = oracle.adversarial_clip_iq(cfg, seed=3)
    got = np.asarray(SectorProcessor(cfg, method=method).power(
        to_planar(adv)[None]))[0]
    assert got.shape == (channels, cfg.num_output_bins)
    err = oracle.relative_l2(oracle.channel_power(adv, cfg), got)
    assert err < LIMITS["adversarial"], err


def test_route_parity_reports_every_limit():
    cfg = _cfg(3)
    out = route_parity(SectorProcessor(cfg, method="parseval"), cfg)
    assert out["ok"] and out["precision"] == "highest"
    assert set(LIMITS) <= set(out)
    fft = route_parity(SectorProcessor(cfg, method="fft"), cfg)
    assert fft["ok"] and fft["precision"] is None    # no dots to name


@pytest.mark.parametrize("platform,want", [("gpu", "bf16x3"),
                                           ("cpu", "highest")])
def test_precision_for_platform(platform, want):
    assert pipeline.precision_for(platform) == want
    assert want in pipeline.PRECISIONS


def test_precision_for_unknown_platform_raises():
    with pytest.raises(ValueError, match="no dot precision"):
        pipeline.precision_for("metal")


def test_processor_precision_defaults_to_its_platform():
    cfg = tiny_config(m=32, n=16)
    assert SectorProcessor(cfg).precision == pipeline.precision_for("cpu")
    dev = jax.devices()[0]
    assert SectorProcessor(cfg, device=dev).precision == "highest"
    assert SectorProcessor(cfg, precision="bf16x3").precision == "bf16x3"
    with pytest.raises(ValueError, match="unknown precision"):
        SectorProcessor(cfg, precision="fast")


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs
    included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


@pytest.mark.parametrize("method", ["parseval", "radix", "mxu"])
def test_every_dot_names_its_precision(method):
    """No dot may run at the backend's default precision (TF32 on the
    GPU): each carries the processor's precision explicitly."""
    cfg = _cfg(3)
    proc = SectorProcessor(cfg, method=method, precision="bf16x3")
    x = np.zeros((1, 3, 2, M, N), np.int16)
    precs = _dot_precisions(jax.make_jaxpr(proc.power)(x).jaxpr)
    assert precs, "formulation has no dots?"
    want = pipeline.PRECISIONS["bf16x3"]
    for p in precs:
        assert p is not None and want in (p if isinstance(p, tuple)
                                          else (p,)), p


def test_sharded_dots_name_their_precision():
    from wrp_tpu.parallel import build_sharded_processor, make_mesh

    cfg = tiny_config(m=64, n=32)
    step, _ = build_sharded_processor(cfg, make_mesh(data=2, seq=2),
                                      method="parseval", precision="bf16x6")
    x = np.zeros((2, 3, 2, 64, 32), np.float32)
    precs = _dot_precisions(jax.make_jaxpr(step)(x).jaxpr)
    want = pipeline.PRECISIONS["bf16x6"]
    assert precs and all(want in (p if isinstance(p, tuple) else (p,))
                         for p in precs), precs
