"""The benchmark harness itself is part of the proof surface: its JSON
contract, its parity self-check, its refusal to time the CPU, and the
sharded (shard_map) measurement path must not rot.  Smoke runs on CPU."""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run_bench(*flags, lines=False):
    from conftest import cpu_subprocess_env

    env = cpu_subprocess_env(
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "bench.py", "--smoke", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-2000:])
    rows = [json.loads(r) for r in out.stdout.strip().splitlines()]
    return rows if lines else rows[-1]


def test_bench_smoke_json_contract():
    r = _run_bench()
    assert r["metric"] == "sectors_per_second_3ch"
    assert r["value"] > 0 and r["unit"] == "sectors/s"
    assert r["vs_baseline"] > 0
    # the flagship route, gated by its parity check (exit 1 + JSON error
    # on failure); the measurements ride in the result
    from wrp_tpu.parity import LIMITS
    from wrp_tpu.pipeline import DEFAULT_METHOD

    assert r["method"] == DEFAULT_METHOD and r["in_dtype"] == "i16"
    assert r["parity_ok"]
    for k, lim in LIMITS.items():
        assert r["parity"][k] < lim, k
    assert r["parity"]["salted"] < 1e-3
    # the pipelined with-H2D metric (the streaming form) rides in every
    # result, and every result names its device
    assert r["sectors_per_second_with_h2d_pipelined"] > 0
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 8
    assert "card" in r


def test_bench_smoke_sharded_runs_under_mesh():
    """--sharded wraps the salted loop around the data-parallel sharded
    step; its parity against the single-device route rides along."""
    r = _run_bench("--sharded", "2")
    assert r["sharded_devices"] == 2
    assert r["sharded_parity_rel_l2"] < 1e-5
    assert r["value"] > 0


def test_bench_smoke_salted_xla_method():
    """Every formulation runs under the per-step-salted loop; the
    self-check pins the cancellation residual."""
    r = _run_bench("--method", "parseval")
    assert r["method"] == "parseval"
    assert r["parity"]["salted"] < 1e-3


def test_bench_smoke_wire_staging_decodes_on_chip():
    """--in-dtype wire stages RAW reference wire bytes and decodes them
    on the device inside the timed span; the parity gate proves the
    route still matches the oracle."""
    r = _run_bench("--in-dtype", "wire")
    assert r["in_dtype"] == "wire" and r["parity_ok"]
    assert r["sectors_per_second_with_h2d"] > 0
    assert r["value"] > 0


def test_bench_smoke_wire_xla_decode_mode():
    """The on-device decode is plain XLA and feeds any formulation."""
    r = _run_bench("--in-dtype", "wire", "--method", "mxu")
    assert r["method"] == "mxu" and r["parity_ok"]
    assert r["value"] > 0


def test_bench_routes_smoke_table():
    """--routes times every formulation under every dot precision on one
    staging; a precision the backend refuses is recorded, not hidden,
    and the summary names the fastest route inside the limits."""
    from wrp_tpu.pipeline import METHODS, PRECISIONS

    rows = _run_bench("--routes", lines=True)
    routes, summary = rows[:-1], rows[-1]
    assert len(routes) == 1 + (len(METHODS) - 1) * len(PRECISIONS)
    assert {r["method"] for r in routes} == set(METHODS)
    assert all(r.get("parity_ok") or "error" in r for r in routes)
    assert summary["metric"] == "route_table"
    assert summary["fastest_within_tolerance"]["method"] in METHODS


def test_bench_without_gpu_exits_nonzero():
    """Outside --smoke the bench measures the card only: on the CPU it
    exits non-zero and prints no result."""
    from conftest import cpu_subprocess_env

    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=cpu_subprocess_env())
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_consolidation_soak_smoke_contract():
    """tools/consolidation_soak.py (the N-feeds-one-card scaling soak)
    must keep its per-feed JSON contract alive: a udp+zmq feed pair, per-feed latency percentiles,
    loss accounting, and the per-feed fp64-oracle contamination check
    (with its wrong-feed teeth probe)."""
    from conftest import cpu_subprocess_env

    out = subprocess.run(
        [sys.executable, "tools/consolidation_soak.py", "--smoke",
         # dedicated port range: the tool's default base collides with
         # any concurrently-running real soak on the same box
         "--base-port", "23150"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=cpu_subprocess_env())
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-2000:])
    lines = [json.loads(l) for l in out.stdout.strip().splitlines()]
    record = lines[-1]
    assert record["metric"] == "consolidation_soak"
    assert record["kinds"] == ["udp", "zmq"]
    assert record["contamination_failures"] == []
    assert len(record["per_feed"]) == 2
    for row in record["per_feed"]:
        assert row["processed_sectors"] > 0
        assert row["verify_rel_l2_max"] < 1e-6     # CPU fp32 floor
        assert row["p99_ms"] is not None
