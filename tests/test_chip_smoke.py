"""chip_smoke.py's contract and its phase functions, run here at tiny
size on the CPU (the card run is `python chip_smoke.py`)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from wrp_tpu.config import tiny_config
from wrp_tpu.device import NoGPUError
from wrp_tpu.pipeline import METHODS

REPO = Path(__file__).resolve().parent.parent


def _small(tmp_path, **kw):
    base = dict(channels=2, stream_batch=2, lockstep_sectors=2,
                lockstep_batch=2, rate=4.0, pool=3, samples=2,
                timeout_s=240.0, workdir=tmp_path)
    base.update(kw)
    return chip_smoke.SmokeConfig(**base)


def test_main_refuses_a_cpu_device(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_four_cards_refuses_without_cards(capsys):
    assert chip_smoke.main(["--four-cards"]) != 0
    assert capsys.readouterr().out == ""


def test_script_alone_fails_without_output(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0 and out.stdout == ""


def test_phase_device_refuses_cpu():
    with pytest.raises(NoGPUError):
        chip_smoke.phase_device()


def test_last_lines_name_the_card_then_the_device(monkeypatch, capsys):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "run_one_card", lambda sc: {
        "phase": "device", "ok": True, "device": dev,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W"})
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": dev}


def test_failed_phase_exits_nonzero(monkeypatch):
    monkeypatch.setattr(chip_smoke, "phase_device",
                        lambda: {"phase": "device", "ok": False})
    with pytest.raises(SystemExit) as e:
        chip_smoke.run_one_card(chip_smoke.SmokeConfig())
    assert e.value.code != 0


def test_phase_parity_tiny():
    rec = chip_smoke.phase_parity(tiny_config(m=256, n=256), batch=4)
    assert rec["ok"], rec
    assert set(rec["routes"]) == set(METHODS)
    assert rec["device_decode_vs_host_rel_l2"] == 0.0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("device_decode", [False, True])
def test_phase_stream_on_cpu(tmp_path, device_decode):
    """The served path end to end at full width, a few sectors: zero
    drops, the consumer's volume equals the processor's, oracle-checked
    samples."""
    rec = chip_smoke.phase_stream(_small(tmp_path), 4,
                                  device_decode=device_decode)
    assert rec["ok"], rec
    assert rec["drops"] == 0 and rec["volume_match"]
    assert rec["host_decoder"] in (("device",) if device_decode
                                   else ("native", "numpy"))


def test_phase_lockstep_two_cpu_processes(tmp_path, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    rec = chip_smoke.phase_lockstep(_small(tmp_path), hosts=2, cards=0)
    assert rec["ok"], rec
    assert rec["covered_sectors"] == [2, 2]


def test_phase_mesh_four_virtual_devices():
    rec = chip_smoke.phase_mesh(tiny_config(m=64, n=32), batch=4)
    assert rec["ok"], rec
    assert {"data_parallel_4x1", "pulse_shard_1x4",
            "pulse_shard_1x4_wire"} <= set(rec)
