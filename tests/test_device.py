"""Where the program runs: the compile-cache rule, the device record,
the one-card-per-process environment, and the native codec built from
its committed sources."""

import os
import tempfile
from pathlib import Path

import jax
import pytest

from wrp_tpu import device

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_a_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(device.compile_cache_dir())
    assert path == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_compile_cache_path_has_no_temp_pid_or_time(monkeypatch):
    """The path is part of the cache's key: one that moves per process,
    per run or per temp dir never hits."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = device.compile_cache_dir()
    assert device.compile_cache_dir() == first
    assert str(os.getpid()) not in first
    assert not first.startswith(tempfile.gettempdir())
    assert not any(ch.isdigit() for ch in Path(first).name)


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_device_record_and_gpu_refusal():
    rec = device.device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())
    with pytest.raises(device.NoGPUError, match="no GPU"):
        device.require_gpu()


def test_no_nvidia_smi_means_no_cards(monkeypatch):
    monkeypatch.setattr(device.shutil, "which", lambda _: None)
    assert device.visible_cards() == 0
    assert device.card_name_power() is None


def test_card_env_gives_each_process_one_card():
    env = device.card_env({"KEEP": "1"}, 2, 4)
    assert env == {"KEEP": "1", "CUDA_VISIBLE_DEVICES": "2"}
    base = {"KEEP": "1"}
    assert device.card_env(base, 5, 0) is base        # no cards: untouched
    with pytest.raises(ValueError, match="one process per card"):
        device.card_env(base, 4, 4)


def test_native_library_keyed_on_its_sources(monkeypatch, tmp_path):
    """A library built from other sources is never loaded: the file name
    carries a hash of the sources and flags, and the built library is
    ignored by git (it is built from source at first use)."""
    from wrp_tpu.native import build

    for src in build.SRCS:
        (tmp_path / src.name).write_bytes(src.read_bytes())
    srcs = [tmp_path / s.name for s in build.SRCS]
    monkeypatch.setattr(build, "SRCS", srcs)
    monkeypatch.setattr(build, "HERE", tmp_path)
    key = build.source_key()
    assert build.library_path() == tmp_path / f"libwrpcodec.{key}.so"
    srcs[0].write_bytes(srcs[0].read_bytes() + b"\n// changed\n")
    assert build.source_key() != key
    assert "wrp_tpu/native/libwrpcodec*" in (
        REPO / ".gitignore").read_text().split()


def test_native_codec_loads_the_current_build():
    from wrp_tpu.io import codec
    from wrp_tpu.native import build

    if codec.decoder_name() == "native":
        assert build.library_path().exists()
    assert codec.decoder_name() in ("native", "numpy")
