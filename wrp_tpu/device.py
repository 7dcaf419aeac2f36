"""Where the program runs: the device record every measurement carries,
the card's name and power limit, and the persistent compile cache.

Measurements name the device they ran on and never fall back to the
CPU: a timing taken on XLA's CPU backend says nothing about the card.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

#: Compile cache used when JAX_COMPILATION_CACHE_DIR is not set: one
#: fixed directory inside the checkout (listed in .gitignore), so every
#: process of one checkout shares it and a rerun finds it again.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR as given when set, else the checkout's
    fixed cache directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir()."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def device_record() -> dict:
    """{"platform", "kind", "count"} of the default devices, as JAX
    reports them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_power() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    None where there is no nvidia-smi (a CPU host)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def visible_cards() -> int:
    """Number of NVIDIA cards on this machine (0 without nvidia-smi),
    counted without starting JAX, which would open them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return 0
    out = subprocess.run([exe, "-L"], capture_output=True, text=True,
                         timeout=30)
    if out.returncode != 0:
        return 0
    return sum(1 for line in out.stdout.splitlines()
               if line.startswith("GPU "))


def card_env(env: dict | None, index: int, cards: int) -> dict | None:
    """Environment for the index-th of several JAX processes on one
    machine: with cards > 0 it sees only card `index` (a JAX process
    reserves most of every card it opens, so two on one card fail for
    want of memory).  env None means this process's environment."""
    if not cards:
        return env
    if index >= cards:
        raise ValueError(f"process {index} but {cards} cards: one "
                         "process per card")
    out = dict(os.environ if env is None else env)
    out["CUDA_VISIBLE_DEVICES"] = str(index)
    return out


class NoGPUError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu() -> dict:
    """The device record, or NoGPUError when JAX finds no GPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default device is {rec['platform']!r} "
            f"({rec['kind']}); this measurement runs only on the card")
    return rec
