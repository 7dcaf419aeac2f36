"""Vectorised wire codecs for the radar formats.

Wire IQ format (reference sector.cpp:52-62, read_single.cc:15): one sector =
m*n samples x 12 bytes, each sample interleaved big-endian int16
``hhI hhQ vvI vvQ vhI vhQ``.  The reference decodes this with a 6.3M-iteration
scalar host loop — its measured ingest bottleneck (SURVEY.md section 6).
Here it is a zero-copy numpy view + transpose (and optionally the C++
native codec in wrp_tpu.native, ~4x faster still).

Result format (floats.c:3-43): big-endian float32 arrays with 2- or 4-byte
big-endian integer headers (see frames.py for the framing).
"""

from __future__ import annotations

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG

try:  # optional C++ fast path, built by wrp_tpu.native.build
    from ..native import codec_native as _native
except Exception:  # pragma: no cover - native lib absent
    _native = None


def decoder_name() -> str:
    """Which host decoder runs: "native" (the C++ codec, built from
    wrp_tpu/native at first use) or "numpy" (the vectorised fallback)."""
    return "native" if _native is not None else "numpy"


def radix_row_order(m: int, radix: int) -> np.ndarray:
    """Natural row index -> position for the radix-DIT row order: rows
    in (p, t) order, j = radix*t + p.  The one copy of this permutation
    (host decode, wire reorder and the device decode all use it)."""
    return np.concatenate([np.arange(p, m, radix) for p in range(radix)])


def pair_lanes(x: np.ndarray, g: int = 2) -> np.ndarray:
    """[bc, 2, m, n] -> [bc/g, 2, m, g*n]: g consecutive channel-sectors
    lane-concatenated — the layout decode_iq_i16_grouped emits, for
    staging and test paths that start from the per-sector layout."""
    bc, two, m, n = x.shape
    if bc % g:
        raise ValueError(f"{bc} channel-sectors do not group by {g}")
    return np.ascontiguousarray(
        x.reshape(bc // g, g, two, m, n).transpose(0, 2, 3, 1, 4)
        .reshape(bc // g, two, m, g * n))


def decode_iq(buf: bytes | bytearray | memoryview | np.ndarray,
              cfg: RadarConfig = DEFAULT_CONFIG,
              planar_out: np.ndarray | None = None) -> np.ndarray:
    """Wire bytes -> float32 planar IQ [channels, 2(I/Q), m, n].

    Kept as a real-valued [C, 2, m, n] array rather than complex64 so the
    host never touches complex packing; `to_complex` converts on demand and
    device code can consume either layout.
    """
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if _native is not None:
        return _native.decode_iq(buf, m, n, ch, out=planar_out)
    expected = m * n * cfg.bytes_per_sample
    raw = np.frombuffer(buf, dtype=">i2", count=expected // 2)
    # [m, n, ch, 2] -> [ch, 2, m, n]
    shaped = raw.reshape(m, n, ch, 2)
    out = planar_out if planar_out is not None else np.empty(
        (ch, 2, m, n), np.float32)
    np.copyto(out, shaped.transpose(2, 3, 0, 1))
    return out


def decode_iq_i16(buf: bytes | bytearray | memoryview | np.ndarray,
                  cfg: RadarConfig = DEFAULT_CONFIG,
                  planar_out: np.ndarray | None = None,
                  radix: int = 1) -> np.ndarray:
    """Wire bytes -> int16 planar IQ [channels, 2(I/Q), m, n].

    The compact device-feed layout: the 14-bit ADC samples ARE int16, so
    shipping int16 to the device halves host->device bytes and the
    chain's device-memory input read; conversion to f32 happens on the
    device.  radix > 1 writes the range rows in radix_row_order."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if _native is not None:
        return _native.decode_iq_i16(buf, m, n, ch, out=planar_out,
                                     radix=radix)
    expected = m * n * cfg.bytes_per_sample
    raw = np.frombuffer(buf, dtype=">i2", count=expected // 2)
    shaped = raw.reshape(m, n, ch, 2)
    out = planar_out if planar_out is not None else np.empty(
        (ch, 2, m, n), np.int16)
    planar = shaped.transpose(2, 3, 0, 1)
    if radix > 1:
        planar = planar[:, :, radix_row_order(m, radix), :]
    np.copyto(out, planar)
    return out


def reorder_wire_rows(buf: bytes | bytearray | memoryview | np.ndarray,
                      cfg: RadarConfig = DEFAULT_CONFIG,
                      radix: int = 1,
                      out: np.ndarray | None = None) -> np.ndarray:
    """RAW wire bytes -> the same bytes with range ROWS in radix-DIT order
    (uint8 [m * n * bps], one contiguous 6 KB-row gather — memcpy speed).

    On the host this is a row-placement copy, and free for v1
    per-row-datagram ingest, where reassembly already places each row
    by index (reference read_single.cc:15 row framing).
    """
    m, n = cfg.num_range_cells, cfg.num_pulses
    row_bytes = n * cfg.bytes_per_sample
    rows = np.frombuffer(buf, np.uint8,
                         count=m * row_bytes).reshape(m, row_bytes)
    if radix <= 1:
        flat = rows.reshape(-1)
        if out is None:
            return flat.copy()
        np.copyto(out, flat)
        return out
    order = radix_row_order(m, radix)
    if out is None:
        return rows[order].reshape(-1)
    np.copyto(out.reshape(m, row_bytes), rows[order])
    return out


def decode_iq_i16_grouped(buf, stage: np.ndarray, slot: int, group: int,
                          cfg: RadarConfig = DEFAULT_CONFIG,
                          radix: int = 1) -> None:
    """Decode ONE wire sector directly into a lane-grouped staging
    buffer ``stage[total_cs/group, 2, m, group*n]`` (int16) at batch
    slot ``slot`` — the pair_lanes layout, emitted by the decode pass
    itself.  Channel-sector ``i = slot*ch + c`` lands in group
    ``i//group``, lane block ``i%group``; with the native codec this
    costs the same as the plain planar emit (identical loops, different
    destination offsets)."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if _native is not None:
        _native.decode_iq_i16_grouped(buf, m, n, ch, stage, slot, group,
                                      radix=radix)
        return
    if stage.dtype != np.int16 or stage.shape[1:] != (2, m, group * n):
        raise ValueError(
            f"stage must be int16 [cs/{group}, 2, {m}, {group * n}]; "
            f"got {stage.dtype} {stage.shape}")
    i_last = slot * ch + ch - 1
    if slot < 0 or i_last // group >= stage.shape[0]:
        raise ValueError(
            f"slot {slot} writes channel-sector {i_last}, beyond the "
            f"stage's {stage.shape[0] * group} channel-sectors")
    planar = decode_iq_i16(buf, cfg, radix=radix)
    for c in range(ch):
        i = slot * ch + c
        lane = (i % group) * n
        stage[i // group, :, :, lane:lane + n] = planar[c]


def to_complex(planar: np.ndarray) -> np.ndarray:
    """[C, 2, m, n] float32 -> [C, m, n] complex64."""
    return (planar[:, 0] + 1j * planar[:, 1]).astype(np.complex64)


def encode_iq(iq: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> bytes:
    """Inverse of decode_iq for producers/tests: [C, m, n] complex (integer
    valued) -> interleaved BE int16 wire bytes."""
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    assert iq.shape == (ch, m, n), iq.shape
    out = np.empty((m, n, ch, 2), dtype=">i2")
    out[..., 0] = np.round(iq.real).astype(np.int16).transpose(1, 2, 0)
    out[..., 1] = np.round(iq.imag).astype(np.int16).transpose(1, 2, 0)
    return out.tobytes()


def encode_be_float32(a: np.ndarray) -> bytes:
    """float32 array -> big-endian bytes (floats.c aftoab)."""
    return np.ascontiguousarray(a, dtype=">f4").tobytes()


def decode_be_float32(buf: bytes, count: int = -1) -> np.ndarray:
    """Big-endian float32 bytes -> float32 array (floats.c abtoaf)."""
    return np.frombuffer(buf, dtype=">f4", count=count).astype(np.float32)
