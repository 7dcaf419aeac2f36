"""ctypes binding for the native wire codec (codec.cpp).

Importing this module builds the shared library on demand; any failure
raises ImportError so callers fall back to the vectorised numpy path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

try:
    from .build import build

    _lib = ctypes.CDLL(str(build()))
except Exception as e:  # pragma: no cover - toolchain absent
    raise ImportError(f"native codec unavailable: {e}") from e

_lib.wrp_decode_iq.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
]
_lib.wrp_decode_iq_i16.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ctypes.c_int32,
]
_lib.wrp_decode_iq_i16_grouped.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
]
_lib.wrp_encode_iq.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
]
_lib.wrp_encode_be_f32.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
]

_DEFAULT_THREADS = int(os.environ.get("WRP_CODEC_THREADS",
                                      min(6, os.cpu_count() or 1)))


def _as_u8(buf) -> np.ndarray:
    """Zero-copy uint8 view over bytes/bytearray/memoryview/ndarray."""
    return np.frombuffer(buf, np.uint8)


def _check_out(out: np.ndarray, shape, dtype) -> np.ndarray:
    """Validate a caller-supplied output array before handing its raw
    pointer to C++: a wrong dtype/shape or a non-contiguous view would
    be silent memory corruption, not an exception (the numpy fallback
    path accepts those via np.copyto, so the two paths must not
    diverge by UB)."""
    if out.shape != tuple(shape) or out.dtype != dtype:
        raise ValueError(
            f"out must be {dtype} {tuple(shape)}, got {out.dtype} "
            f"{out.shape}")
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be C-contiguous and writeable")
    return out


def decode_iq(wire, m: int, n: int, ch: int,
              out: np.ndarray | None = None,
              num_threads: int = _DEFAULT_THREADS) -> np.ndarray:
    """Wire bytes -> planar float32 [ch, 2, m, n]."""
    if out is None:
        out = np.empty((ch, 2, m, n), np.float32)
    else:
        _check_out(out, (ch, 2, m, n), np.float32)
    src = _as_u8(wire)
    # a hard check, not an assert: a short network buffer reaching the
    # native decoder would be an out-of-bounds READ, and asserts vanish
    # under python -O
    if src.size < m * n * ch * 4:
        raise ValueError(
            f"wire buffer too short: {src.size} < {m * n * ch * 4}")
    _lib.wrp_decode_iq(src.ctypes.data, out.ctypes.data, m, n, ch,
                       num_threads)
    return out


def decode_iq_i16(wire, m: int, n: int, ch: int,
                  out: np.ndarray | None = None,
                  num_threads: int = _DEFAULT_THREADS,
                  radix: int = 1) -> np.ndarray:
    """Wire bytes -> planar int16 [ch, 2, m, n] (compact device feed).
    radix > 1 writes range rows in radix-DIT order."""
    if out is None:
        out = np.empty((ch, 2, m, n), np.int16)
    else:
        _check_out(out, (ch, 2, m, n), np.int16)
    if radix > 1 and m % radix:
        raise ValueError(f"radix {radix} must divide m={m} (colliding "
                         "row offsets otherwise)")
    src = _as_u8(wire)
    if src.size < m * n * ch * 4:   # see decode_iq: OOB-read guard
        raise ValueError(
            f"wire buffer too short: {src.size} < {m * n * ch * 4}")
    _lib.wrp_decode_iq_i16(src.ctypes.data, out.ctypes.data, m, n, ch,
                           num_threads, radix)
    return out


def decode_iq_i16_grouped(wire, m: int, n: int, ch: int,
                          stage: np.ndarray, slot: int, group: int,
                          num_threads: int = _DEFAULT_THREADS,
                          radix: int = 1) -> None:
    """Scatter ONE wire sector into a lane-grouped staging buffer
    stage[total_cs/group, 2, m, group*n] at batch slot `slot` — the
    io/codec.pair_lanes layout, emitted during the decode
    pass itself (same loops as decode_iq_i16; only destination offsets
    change)."""
    if group < 1 or stage.ndim != 4:
        raise ValueError(f"need group >= 1 and a 4-d stage; got {group}, "
                         f"{stage.shape}")
    _check_out(stage, stage.shape, np.int16)
    if stage.shape[1:] != (2, m, group * n):
        raise ValueError(f"stage must be [cs/{group}, 2, {m}, {group * n}]"
                         f"; got {stage.shape}")
    if radix > 1 and m % radix:
        raise ValueError(f"radix {radix} must divide m={m}")
    i_last = slot * ch + ch - 1
    if slot < 0 or i_last // group >= stage.shape[0]:
        raise ValueError(
            f"slot {slot} writes channel-sector {i_last}, beyond the "
            f"stage's {stage.shape[0] * group} channel-sectors")
    src = _as_u8(wire)
    if src.size < m * n * ch * 4:   # see decode_iq: OOB-read guard
        raise ValueError(
            f"wire buffer too short: {src.size} < {m * n * ch * 4}")
    _lib.wrp_decode_iq_i16_grouped(src.ctypes.data, stage.ctypes.data,
                                   m, n, ch, num_threads, radix, group,
                                   slot)


def encode_iq(planar: np.ndarray) -> bytes:
    ch, two, m, n = planar.shape
    assert two == 2
    planar = np.ascontiguousarray(planar, np.float32)
    wire = np.empty(m * n * ch * 4, np.uint8)
    _lib.wrp_encode_iq(planar.ctypes.data, wire.ctypes.data, m, n, ch)
    return wire.tobytes()


def encode_be_f32(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a, np.float32)
    out = np.empty(a.size * 4, np.uint8)
    _lib.wrp_encode_be_f32(a.ctypes.data, out.ctypes.data, a.size)
    return out.tobytes()
