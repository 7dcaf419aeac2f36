"""Build the native codec shared library (g++, no external deps).

Invoked automatically on first import of wrp_tpu.native.codec_native, or
manually: python -m wrp_tpu.native.build

The library is never committed.  Its file name carries a hash of the
sources and the compile command, so a checkout builds it at first use,
and a library built from other sources is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRCS = [HERE / "codec.cpp", HERE / "ingest.cpp"]
FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
         "-std=c++17", "-pthread"]


def source_key() -> str:
    """Hash of the sources and compile flags the library is built from."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SRCS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return HERE / f"libwrpcodec.{source_key()}.so"


def build(force: bool = False) -> Path:
    lib = library_path()
    if lib.exists() and not force:
        return lib
    # build under a private name, then rename: concurrent first imports
    # (test workers, a stream and its producer) never load a half-written
    # library
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, *map(str, SRCS), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


if __name__ == "__main__":
    print(build(force=True))
