#!/usr/bin/env python
"""Multi-host weak-scaling benchmark (BASELINE.json config 5).

Spawns N processes that form one global jax mesh (gloo-backed virtual CPU
devices here; the identical code path runs NCCL between cards),
each feeding its own per-host sector batch — measures aggregate sectors/s
at 1 host and at N hosts and reports the weak-scaling efficiency.

    python tools/multihost_bench.py --hosts 2 --devices-per-host 4 \
        --per-host-batch 8 --steps 8

Prints one JSON line:
    {"metric": "multihost_weak_scaling", "hosts": N, "efficiency": E, ...}
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = r"""
import os, sys, time
pid, nproc, port, vdev, B, steps, m, n = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]))
method = sys.argv[9] if len(sys.argv) > 9 else "mxu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={vdev}"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from wrp_tpu.config import tiny_config
from wrp_tpu.parallel.multihost import MultiHostProcessor, init_distributed

if nproc > 1:
    init_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
cfg = tiny_config(m=m, n=n)
proc = MultiHostProcessor.build(cfg, per_host_batch=B, method=method)
rng = np.random.default_rng(pid)
planar = rng.integers(-2048, 2048, (B, cfg.num_channels, 2, m, n)
                      ).astype(np.float32)
proc.step_local(planar)                     # compile + warm collectives
t0 = time.perf_counter()
for _ in range(steps):
    out = proc.step_local(planar)
dt = time.perf_counter() - t0
print(f"RATE {nproc * B * steps / dt:.2f}", flush=True)
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def run_world(nproc, vdev, batch, steps, m, n, method="mxu"):
    port = free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(nproc), str(port),
             str(vdev), str(batch), str(steps), str(m), str(n), method],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for pid in range(nproc)
    ]
    rates = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed: {err[-2000:]}")
        for line in out.splitlines():
            if line.startswith("RATE "):
                rates.append(float(line.split()[1]))
    # aggregate throughput is what any one worker measured for the whole
    # lock-step world (they step together); take the minimum to be fair
    return min(rates)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=4)
    ap.add_argument("--per-host-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--method", default="mxu",
                    help="a parallel/sharded.SHARD_METHODS formulation")
    args = ap.parse_args()

    import os

    base = run_world(1, args.devices_per_host, args.per_host_batch,
                     args.steps, args.m, args.n, args.method)
    multi = run_world(args.hosts, args.devices_per_host,
                      args.per_host_batch, args.steps, args.m, args.n,
                      args.method)
    eff = multi / (base * args.hosts)
    # All simulated hosts share this machine's physical cores, so raw weak-
    # scaling efficiency is bounded by cpus/(hosts*cpus): with fewer cores
    # than hosts, the ceiling is 1/hosts.  The compute-adjusted figure
    # divides out that time-slicing bound and isolates the actual
    # communication/lock-step overhead (the quantity that transfers to a
    # real pod, where each host has its own chips).
    cpus = os.cpu_count() or 1
    ceiling = min(1.0, cpus / args.hosts) if cpus < args.hosts else 1.0
    print(json.dumps({
        "metric": "multihost_weak_scaling",
        "method": args.method,
        "hosts": args.hosts,
        "devices_per_host": args.devices_per_host,
        "per_host_batch": args.per_host_batch,
        "sectors_per_second_1host": round(base, 2),
        "sectors_per_second_nhost": round(multi, 2),
        "efficiency_raw": round(eff, 3),
        "physical_cpus": cpus,
        "shared_cpu_ceiling": round(ceiling, 3),
        "efficiency_vs_ceiling": round(eff / ceiling, 3),
        "backend": "cpu-gloo (the same code path runs NCCL between cards)",
    }))


if __name__ == "__main__":
    main()
