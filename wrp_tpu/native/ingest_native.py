"""ctypes binding for the native UDP sector ingest loop (ingest.cpp).

The loop runs outside the GIL, so sector reassembly (m datagrams) overlaps
the compute thread's device dispatch — the equivalent of the reference's
host-ingest/GPU-compute cascade (gpu_1fp_streamcasc.cu:527-737).
"""

from __future__ import annotations

import ctypes

import numpy as np

try:
    from .build import build

    _lib = ctypes.CDLL(str(build()))
except Exception as e:  # pragma: no cover - toolchain absent
    raise ImportError(f"native ingest unavailable: {e}") from e

_lib.wrp_udp_recv_sector.argtypes = [
    ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
]
_lib.wrp_udp_recv_sector.restype = ctypes.c_int32


def recv_sector(fd: int, timeout_ms: int, out: bytearray | np.ndarray,
                rows: int, row_bytes: int, stats: np.ndarray,
                hdr: np.ndarray) -> int:
    """Receive one sector into `out` (rows*row_bytes bytes).

    stats: int64[5] (datagrams, dropped_datagrams, dropped_sectors,
    timeouts, duplicate_datagrams), incremented in place.  hdr: int32[3]
    (has_header, sector, elevation) result.  Returns 1 ok, 0 idle,
    -1 stall, -2 socket error.
    """
    buf = np.frombuffer(out, np.uint8)
    assert buf.size >= rows * row_bytes
    assert stats.dtype == np.int64 and stats.size == 5
    assert hdr.dtype == np.int32 and hdr.size == 3
    return _lib.wrp_udp_recv_sector(
        fd, timeout_ms, buf.ctypes.data, rows, row_bytes,
        stats.ctypes.data, hdr.ctypes.data,
    )
