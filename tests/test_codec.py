"""Wire codec semantics vs the reference byte layouts
(sector.cpp:52-62, floats.c:3-43)."""

import numpy as np
from wrp_tpu.config import tiny_config
from wrp_tpu.io import codec, frames


def test_decode_reference_byte_order():
    """Hand-build one sample in the reference's interleaved BE layout and
    check channel/I-Q placement."""
    cfg = tiny_config(m=2, n=2)
    # sample (i=0, j=0): hhI=1, hhQ=-2, vvI=3, vvQ=-4, vhI=5, vhQ=-6
    samples = np.arange(1, 25).reshape(4, 6).astype(np.int16)
    samples[:, 1::2] *= -1
    wire = samples.astype(">i2").tobytes()
    planar = codec.decode_iq(wire, cfg)
    assert planar.shape == (3, 2, 2, 2)
    # first sample
    assert planar[0, 0, 0, 0] == 1 and planar[0, 1, 0, 0] == -2   # hh I/Q
    assert planar[1, 0, 0, 0] == 3 and planar[1, 1, 0, 0] == -4   # vv
    assert planar[2, 0, 0, 0] == 5 and planar[2, 1, 0, 0] == -6   # vh
    # row-major: sample (0,1) is the second group of 6
    assert planar[0, 0, 0, 1] == 7


def test_iq_roundtrip():
    cfg = tiny_config(m=16, n=8)
    rng = np.random.default_rng(0)
    iq = (rng.integers(-8192, 8192, cfg.sector_shape)
          + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
    wire = codec.encode_iq(iq, cfg)
    assert len(wire) == cfg.sector_nbytes_wire
    planar = codec.decode_iq(wire, cfg)
    np.testing.assert_array_equal(codec.to_complex(planar),
                                  iq.astype(np.complex64))


def test_int16_extremes_roundtrip():
    cfg = tiny_config(m=2, n=2)
    iq = np.full(cfg.sector_shape, -32768 - 32767j, np.complex128)
    iq[0, 0, 0] = 32767 + 0j
    planar = codec.decode_iq(codec.encode_iq(iq, cfg), cfg)
    assert planar[0, 0, 0, 0] == 32767
    assert planar[1, 0, 0, 0] == -32768 and planar[1, 1, 0, 0] == -32767


def test_be_float32_roundtrip():
    vals = np.array([0.0, -1.5, 3.14159, np.inf, -np.inf, 1e-30], np.float32)
    buf = codec.encode_be_float32(vals)
    assert len(buf) == 4 * len(vals)
    np.testing.assert_array_equal(codec.decode_be_float32(buf), vals)


def test_be_float32_matches_reference_ftob():
    """floats.c:3-13 writes the fp32 bit pattern MSB-first; 1.0f ->
    3f 80 00 00."""
    assert codec.encode_be_float32(np.array([1.0], np.float32)) == bytes(
        [0x3F, 0x80, 0x00, 0x00])


def test_result_frame_v1():
    vals = np.linspace(-50, 50, 512).astype(np.float32)
    buf = frames.pack_result_v1(7, vals)
    assert len(buf) == 2 + 512 * 4   # read_single.cc:510 layout
    sector, got = frames.unpack_result_v1(buf)
    assert sector == 7
    np.testing.assert_array_equal(got, vals)


def test_result_frame_v2():
    vals = np.linspace(-50, 50, 512).astype(np.float32)
    buf = frames.pack_result_v2(142, 8, vals)
    assert len(buf) == 4 + 512 * 4   # rpv2.cu:631 layout
    sector, elevation, got = frames.unpack_result_v2(buf)
    assert (sector, elevation) == (142, 8)
    np.testing.assert_array_equal(got, vals)


def test_result_frame_v1x_roundtrip_and_v1_passthrough():
    """v1x frames carry the elevation behind a magic whose high bit is
    set, so unpack_result_udp can tell the flavours apart: sector ids are
    small non-negative int16s and can never equal RESULT_MAGIC."""
    vals = np.linspace(-50, 50, 512).astype(np.float32)
    buf = frames.pack_result_v1x(17, 5, vals)
    assert len(buf) == 6 + 512 * 4
    sector, elev, got = frames.unpack_result_udp(buf)
    assert (sector, elev) == (17, 5)
    np.testing.assert_array_equal(got, vals)
    # bare v1 frames report elevation None
    sector, elev, got = frames.unpack_result_udp(frames.pack_result_v1(9, vals))
    assert (sector, elev) == (9, None)
    np.testing.assert_array_equal(got, vals)
    assert frames.RESULT_MAGIC > 0x7FFF  # can't collide with a sector id


def test_ingest_header_roundtrip_and_passthrough():
    payload = b"\x01\x02" * 16
    buf = frames.pack_ingest_row(frames.IngestHeader(5, 3, 999), payload)
    header, got = frames.try_unpack_ingest_row(buf)
    assert (header.sector, header.elevation, header.row) == (5, 3, 999)
    assert got == payload
    # raw v1 datagrams pass through unchanged
    header, got = frames.try_unpack_ingest_row(payload)
    assert header is None and got == payload


def test_decode_matches_scalar_reference_loop(rng):
    """Cross-check the vectorised decode against a literal scalar
    re-implementation of Sector::fromByteArray byte maths."""
    cfg = tiny_config(m=4, n=4)
    wire = bytes(rng.integers(0, 256, cfg.sector_nbytes_wire, np.uint8))
    planar = codec.decode_iq(wire, cfg)
    idx = 0
    for i in range(cfg.m):
        for j in range(cfg.n):
            for ch in range(3):
                for part in range(2):
                    hi, lo = wire[idx], wire[idx + 1]
                    idx += 2
                    val = ((hi << 8) & 0xFF00) + (lo & 0xFF)
                    if val >= 32768:
                        val -= 65536
                    assert planar[ch, part, i, j] == np.float32(val)


def test_decode_iq_i16_matches_f32():
    """The compact int16 device feed decodes to the same values as the
    float32 path (both native and numpy implementations)."""
    from wrp_tpu.config import tiny_config
    from wrp_tpu.io import codec

    cfg = tiny_config(m=16, n=8)
    rng = np.random.default_rng(5)
    iq = (rng.integers(-8192, 8192, cfg.sector_shape)
          + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
    wire = codec.encode_iq(iq, cfg)
    p16 = codec.decode_iq_i16(wire, cfg)
    assert p16.dtype == np.int16
    np.testing.assert_array_equal(p16.astype(np.float32),
                                  codec.decode_iq(wire, cfg))


def test_pipeline_accepts_i16_planar():

    from wrp_tpu import oracle
    from wrp_tpu.config import tiny_config
    from wrp_tpu.io import codec
    from wrp_tpu.pipeline import DEFAULT_METHOD, SectorProcessor

    cfg = tiny_config(m=64, n=32)
    rng = np.random.default_rng(6)
    iq = (rng.integers(-8192, 8192, cfg.sector_shape)
          + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
    zdb64, _ = oracle.process_sector(iq, cfg)
    p16 = codec.decode_iq_i16(codec.encode_iq(iq, cfg), cfg)
    for method in ("mxu", DEFAULT_METHOD):
        proc = SectorProcessor(cfg, method=method)
        zdb, _ = proc(p16[None])
        assert oracle.relative_l2(zdb64, np.asarray(zdb)[0]) < 1e-5


def test_two_channel_config_codec_roundtrip():
    """bytes_per_sample derives from num_channels, so reduced-channel
    configs keep wire sizes consistent (code-review regression)."""
    from wrp_tpu.config import tiny_config
    from wrp_tpu.io import codec

    cfg = tiny_config(m=16, n=8, channels=2)
    assert cfg.bytes_per_sample == 8
    rng = np.random.default_rng(7)
    iq = (rng.integers(-8192, 8192, cfg.sector_shape)
          + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
    wire = codec.encode_iq(iq, cfg)
    assert len(wire) == cfg.sector_nbytes_wire
    planar = codec.decode_iq(wire, cfg)
    np.testing.assert_array_equal(codec.to_complex(planar),
                                  iq.astype(np.complex64))


def test_wire_parsers_fuzz_clean_failures():
    """Network-facing parsers must fail with clean, expected exceptions
    (or succeed) on arbitrary bytes — never segfault, hang, or raise
    surprise types.  A tiny bounded fuzz over sizes near the parsers'
    thresholds."""
    import struct

    from wrp_tpu.config import tiny_config
    from wrp_tpu.io import codec, frames

    cfg = tiny_config(m=16, n=8)
    rng = np.random.default_rng(0)
    ok_types = (ValueError, struct.error)
    sizes = [0, 1, 2, 3, 5, 7, 8, 15, 16, 17, 63, 64, 100,
             cfg.sector_nbytes_wire - 1, cfg.sector_nbytes_wire,
             cfg.sector_nbytes_wire + 3]
    for size in sizes:
        for trial in range(3):
            buf = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            for parse in (
                lambda b: codec.decode_iq(b, cfg),
                lambda b: codec.decode_iq_i16(b, cfg),
                frames.unpack_result_v1,
                frames.unpack_result_v2,
                frames.unpack_result_udp,
                frames.try_unpack_ingest_row,
            ):
                try:
                    parse(buf)
                except ok_types:
                    pass
    # a buffer that happens to start with the v1x magic but is truncated
    # must fail cleanly OR parse to a detectably short values array —
    # never mis-slice into plausible-looking garbage
    full = frames.pack_result_v1x(1, 2, np.zeros(4, np.float32))
    for n in range(0, len(full) + 1):
        try:
            got = frames.unpack_result_udp(full[:n])
        except ok_types:
            continue
        sector, elev, values = got
        if elev is not None:                  # parsed as v1x
            assert (sector, elev) == (1, 2)
            assert len(values) == (n - 6) // 4  # truncation is visible
        else:                                 # too short for the magic:
            assert n < 6                      # fell back to v1 parsing
    # the downstream consumer rejects any wrong-length values array
    sector, elev, values = frames.unpack_result_udp(full[:10])
    assert len(values) == 1 != 4


def test_device_decode_matches_host_decoder_exactly():
    """ops/device_codec.decode_wire_i16 (device-side decode) must be
    bit-identical to the host decoder for every layout it replaces:
    natural order, radix order, batched, int16 extremes included."""
    import jax
    from wrp_tpu.ops.device_codec import decode_wire_i16

    cfg = tiny_config(m=16, n=8)
    rng = np.random.default_rng(3)
    vals = rng.integers(-32768, 32768,
                        (4, cfg.num_range_cells, cfg.num_pulses,
                         cfg.num_channels, 2), dtype=np.int64)
    vals[0, 0, 0, 0, 0] = -32768            # extremes survive the
    vals[0, 0, 0, 0, 1] = 32767             # int32 sign reconstruction
    wires = [v.astype(">i2").tobytes() for v in vals]
    wire_u8 = np.stack([np.frombuffer(w, np.uint8) for w in wires])

    for radix in (1, 8):
        host = np.stack([codec.decode_iq_i16(w, cfg, radix=radix)
                         for w in wires])
        dev = np.asarray(jax.jit(
            lambda x, r=radix: decode_wire_i16(x, cfg, radix=r))(wire_u8))
        assert dev.dtype == np.int16
        np.testing.assert_array_equal(dev, host)
    # unbatched (no leading axis) decode too
    one = np.asarray(decode_wire_i16(wire_u8[0], cfg, radix=8))
    np.testing.assert_array_equal(one, codec.decode_iq_i16(wires[0], cfg,
                                                           radix=8))
