"""Multi-device sharding on the virtual 8-device CPU mesh.

Validates the distributed transpose-FFT decomposition (data x seq) against
the single-device pipeline and the fp64 oracle.
"""

import numpy as np
import pytest

from wrp_tpu import oracle, pipeline
from wrp_tpu.config import DEFAULT_CONFIG, tiny_config
from wrp_tpu.parallel import make_mesh, build_sharded_processor, shard_batch
from wrp_tpu.parallel.sharded import SHARD_METHODS


@pytest.fixture(scope="module")
def batch():
    cfg = tiny_config(m=128, n=64)
    rng = np.random.default_rng(11)
    iq = (
        rng.integers(-2048, 2048, (8, cfg.num_channels, cfg.m, cfg.n))
        + 1j * rng.integers(-2048, 2048, (8, cfg.num_channels, cfg.m, cfg.n))
    ).astype(np.complex64)
    return cfg, iq


@pytest.mark.parametrize("data,seq", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.parametrize("method", SHARD_METHODS)
def test_sharded_matches_single_device(batch, data, seq, method):
    cfg, iq = batch
    mesh = make_mesh(data=data, seq=seq)
    step, _ = build_sharded_processor(cfg, mesh, method=method)
    zdb_s, zdr_s = step(shard_batch(iq, mesh))
    zdb_s, zdr_s = np.asarray(zdb_s), np.asarray(zdr_s)

    proc = pipeline.SectorProcessor(cfg, method=method)
    zdb_1, zdr_1 = proc(iq)
    zdb_1, zdr_1 = np.asarray(zdb_1), np.asarray(zdr_1)

    # identical math modulo reduction/collective ordering
    assert oracle.relative_l2(zdb_1, zdb_s) < 1e-5
    assert oracle.relative_l2(zdr_1, zdr_s) < 1e-5


@pytest.mark.parametrize("data,seq", [(8, 1), (4, 2)])
def test_pallas_sharded_matches_oracle(batch, data, seq):
    """The flagship route under shard_map matches the fp64 oracle — the
    multi-card story of the default path."""
    cfg, iq = batch
    mesh = make_mesh(data=data, seq=seq)
    step, in_sharding = build_sharded_processor(cfg, mesh)
    zdb_s, zdr_s = step(shard_batch(iq, mesh, in_sharding))
    zdb_s, zdr_s = np.asarray(zdb_s), np.asarray(zdr_s)
    want_zdb, want_zdr = [], []
    for k in range(iq.shape[0]):
        zdb, zdr = oracle.process_sector(iq[k], cfg)
        want_zdb.append(zdb)
        want_zdr.append(zdr)
    assert oracle.relative_l2(np.stack(want_zdb), zdb_s) < 2e-4
    assert oracle.relative_l2(np.stack(want_zdr), zdr_s) < 2e-4


def test_pallas_sharded_matches_single_device(batch):
    """Sharded flagship route == the single-device processor on a 4x1
    mesh (pure data-parallel, the four-card layout)."""
    cfg, iq = batch
    mesh = make_mesh(data=4, seq=1)
    step, in_sharding = build_sharded_processor(cfg, mesh)
    zdb_s, zdr_s = step(shard_batch(iq, mesh, in_sharding))
    proc = pipeline.SectorProcessor(cfg)
    zdb_1, zdr_1 = proc(iq)
    assert oracle.relative_l2(np.asarray(zdb_1), np.asarray(zdb_s)) < 1e-5
    assert oracle.relative_l2(np.asarray(zdr_1), np.asarray(zdr_s)) < 1e-5


@pytest.mark.parametrize("data,seq", [(4, 2), (2, 4), (1, 8)])
def test_pallas_seq_sharded_matches_single_device(batch, data, seq):
    """The pulse-sharded parseval body (Gauss A matmul per pulse slice
    -> all_to_all -> Parseval epilogue per row shard) == the
    single-device parseval processor."""
    cfg, iq = batch
    mesh = make_mesh(data=data, seq=seq)
    step, in_sharding = build_sharded_processor(cfg, mesh,
                                                method="parseval")
    zdb_s, zdr_s = step(shard_batch(iq, mesh, in_sharding))
    proc = pipeline.SectorProcessor(cfg, method="parseval")
    zdb_1, zdr_1 = proc(iq)
    assert oracle.relative_l2(np.asarray(zdb_1), np.asarray(zdb_s)) < 1e-5
    assert oracle.relative_l2(np.asarray(zdr_1), np.asarray(zdr_s)) < 1e-5


def test_pallas_seq_wire_input_matches_planar(batch):
    """wire_input: raw wire bytes sharded by pulse-byte columns, decoded
    on the device per shard — products match the planar step on the same
    sectors (the decode is bit-exact, so int16 vs f32 input differs in
    nothing numerically)."""
    import jax

    from wrp_tpu.io import codec

    cfg, iq = batch
    mesh = make_mesh(data=2, seq=4)
    step_w, shd_w = build_sharded_processor(cfg, mesh, wire_input=True)
    step_p, shd_p = build_sharded_processor(cfg, mesh)
    wires = np.stack([
        np.frombuffer(codec.encode_iq(iq[k], cfg), np.uint8)
        for k in range(iq.shape[0])
    ])
    m, n = cfg.num_range_cells, cfg.num_pulses
    wire3 = wires.reshape(iq.shape[0], m, n * cfg.bytes_per_sample)
    zdb_w, zdr_w = step_w(jax.device_put(wire3, shd_w))
    zdb_p, zdr_p = step_p(shard_batch(iq, mesh, shd_p))
    assert oracle.relative_l2(np.asarray(zdb_p), np.asarray(zdb_w)) < 1e-6
    assert oracle.relative_l2(np.asarray(zdr_p), np.asarray(zdr_w)) < 1e-6


def test_sharded_matches_oracle(batch):
    cfg, iq = batch
    mesh = make_mesh(data=2, seq=4)
    step, _ = build_sharded_processor(cfg, mesh, method="mxu")
    zdb_s, zdr_s = step(shard_batch(iq, mesh))
    want_zdb, want_zdr = [], []
    for k in range(iq.shape[0]):
        zdb, zdr = oracle.process_sector(iq[k], cfg)
        want_zdb.append(zdb)
        want_zdr.append(zdr)
    assert oracle.relative_l2(np.stack(want_zdb), np.asarray(zdb_s)) < 1e-4
    assert oracle.relative_l2(np.stack(want_zdr), np.asarray(zdr_s)) < 1e-4


def test_full_geometry_sharded_smoke():
    """Default 1024x512 geometry through the 2x4 mesh (one batch)."""
    cfg = DEFAULT_CONFIG
    iq = oracle.synthetic_iq(cfg, kind="noise", seed=3)[None].astype(np.complex64)
    iq = np.repeat(iq, 2, axis=0)
    mesh = make_mesh(data=2, seq=4)
    step, _ = build_sharded_processor(cfg, mesh, method="mxu")
    zdb, zdr = step(shard_batch(iq, mesh))
    zdb64, zdr64 = oracle.process_sector(iq[0], cfg)
    assert oracle.relative_l2(zdb64, np.asarray(zdb)[0]) < 1e-4
    assert oracle.relative_l2(zdr64, np.asarray(zdr)[1]) < 1e-3


def test_indivisible_mesh_rejected():
    cfg = tiny_config(m=128, n=64)
    mesh = make_mesh(data=1, seq=8)
    # n=64 divides by 8; m/2=64 divides by 8 -> fine. Now break it:
    cfg_bad = tiny_config(m=128, n=60)
    with pytest.raises(ValueError):
        build_sharded_processor(cfg_bad, mesh)


def test_mesh_construction():
    m = make_mesh()
    assert m.devices.size == 8
    m2 = make_mesh(seq=4)
    assert m2.shape == {"data": 2, "seq": 4}
    with pytest.raises(ValueError):
        make_mesh(data=16, seq=1)


def test_halo_matched_filter_processor():
    """Pulse-sharded end-to-end chain with the overlap-save ppermute halo
    (parallel/halo.py) matches the unsharded pipeline."""
    import numpy as np

    from wrp_tpu import oracle, pipeline
    from wrp_tpu.config import tiny_config
    from wrp_tpu.parallel.mesh import make_mesh
    from wrp_tpu.parallel.halo import build_halo_processor
    from wrp_tpu.parallel.sharded import shard_batch

    cfg = tiny_config(m=64, n=32)
    mesh = make_mesh(data=2, seq=4)
    step, _ = build_halo_processor(cfg, mesh)
    rng = np.random.default_rng(21)
    iq = (rng.integers(-2048, 2048, (4, *cfg.sector_shape))
          + 1j * rng.integers(-2048, 2048, (4, *cfg.sector_shape))
          ).astype(np.complex64)
    zdb, zdr = step(shard_batch(iq, mesh))
    zdb = np.asarray(zdb)
    for k in range(4):
        zdb64, _ = oracle.process_sector(iq[k], cfg)
        assert oracle.relative_l2(zdb64, zdb[k]) < 1e-4


def test_halo_rejects_shards_smaller_than_filter_overlap():
    """n_loc < ma_count-1 would make the one-hop halo silently cover the
    wrong pulse columns (shapes still line up because the pulse axis is
    summed away) — must raise instead."""
    import pytest

    from wrp_tpu.config import tiny_config
    from wrp_tpu.parallel import make_mesh
    from wrp_tpu.parallel.halo import build_halo_processor

    cfg = tiny_config(m=32, n=32)
    mesh = make_mesh(data=1, seq=8)      # n_loc = 4 < 6 taps-1
    with pytest.raises(ValueError, match="overlap"):
        build_halo_processor(cfg, mesh)


def test_pallas_seq_validation_errors(batch):
    """The shard surface refuses bad configurations loudly: a removed or
    unknown method, and indivisible seq geometry."""
    cfg, _ = batch
    mesh = make_mesh(data=2, seq=4)
    with pytest.raises(ValueError, match="unknown shard method"):
        build_sharded_processor(cfg, mesh, method="pallas-seq")
    with pytest.raises(ValueError, match="unknown shard method"):
        build_sharded_processor(cfg, mesh, method="radix")
    cfg_bad = tiny_config(m=128, n=60)     # n=60 % seq=4 ok; m/2=64 ok
    mesh8 = make_mesh(data=1, seq=8)       # 60 % 8 != 0 -> reject
    with pytest.raises(ValueError, match="divide"):
        build_sharded_processor(cfg_bad, mesh8)
