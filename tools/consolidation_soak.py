#!/usr/bin/env python
"""Consolidation-at-scale soak: N concurrent radar feeds through ONE card.

DESIGN.md §6's multiplexing story ("one card ≈ many radars") needs
scaling evidence; this tool produces it: N
feeds (a udp + zmq mix — even feed indices udp, odd zmq), each producing
at a real radar's sector rate, soaked for a fixed duration through one
StreamingExecutor in multi-feed consolidation mode, with per-feed
volumes, per-feed latency percentiles, loss accounting, and a
cross-contamination check that pins each feed's STORED products to that
feed's OWN fp64 oracle (and proves the check has teeth by confirming a
neighbour feed's oracle does NOT match).

The reference processed one feed per GPU and barely kept up
(SURVEY.md §6: 36-73 sectors/s on the 930M); nothing like multi-feed
multiplexing exists there.

Producers use `cli produce --per-sector-seed`, so any sampled sector's
IQ is recomputable from (feed seed, k) alone — verification does not
replay the stream.

Usage:
  python tools/consolidation_soak.py --feeds 4 --duration 60      # on the GPU
  python tools/consolidation_soak.py --feeds 8 --duration 60 --device-decode
  python tools/consolidation_soak.py --smoke          # CPU plumbing check
  ... --out soak.json                                 # append a record

--stub-device: the HOST-PATH proof.  The device step is replaced by an
instant host stub, so the REAL StreamingExecutor loop — transport recv +
datagram reassembly, SIMD decode, queue, batch stack, egress send,
volume store, per-feed stats — runs with the card out of the loop
entirely.  This measures what the reference proved with prof/casc4.prof
(the full wire->compute->wire cascade at rate): whether the HOST side of
wrp_tpu's executor sustains production radar rates, at how many feeds
one host saturates, and how the measured ceiling reconciles with
DESIGN.md §6's ~1,440 decode-sectors/s/core arithmetic.  No oracle
pinning in this mode (the products are stub values; numerical parity is
pinned by the non-stub soaks) — rates, drops, and latency are the
deliverable.  Egress is ON (UDP result frames, the reference's v1
topology) so the send syscalls are inside the measurement.

Prints one JSON line per feed plus a summary line; exits 1 on any
contamination-check failure or dropped sector.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# one real volume scan / minute => ~21.5 sectors/s per radar (SURVEY.md §6)
REAL_RADAR_RATE = 143 * 9 / 60.0


def last_k_for_label(sector: int, elevation: int, sent: int,
                     num_sectors: int = 143, num_elevations: int = 9):
    """Largest global index k < sent whose label is (sector, elevation)
    — the write that survives in the volume (labels cycle with period
    num_sectors * num_elevations)."""
    period = num_sectors * num_elevations
    base = sector + num_sectors * elevation
    if base >= sent:
        return None
    return base + period * ((sent - 1 - base) // period)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--feeds", type=int, default=4)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="producer span in seconds (>=60 for the record)")
    ap.add_argument("--rate", type=float, default=REAL_RADAR_RATE,
                    help="per-feed sectors/s (default: one real radar)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--method", default=None,
                    help="chain formulation (default: the flagship, "
                         "pipeline.DEFAULT_METHOD)")
    ap.add_argument("--device-decode", action="store_true",
                    help="ship raw wire bytes, decode on the device "
                         "(ops/device_codec) — frees the host decode "
                         "cores that otherwise scale with feed count")
    ap.add_argument("--timeout", type=float, default=1.0)
    ap.add_argument("--verify-samples", type=int, default=6,
                    help="labels per feed pinned to the feed's fp64 oracle")
    ap.add_argument("--udp-feeds", type=int, default=1,
                    help="how many of the feeds use the v1 per-row UDP "
                         "wire (syscall-heavy: ~40%% of a core per live "
                         "feed at real rate); the rest use the v2 "
                         "whole-sector zmq wire")
    ap.add_argument("--pool", type=int, default=16,
                    help="producer replay-pool size (pre-encoded distinct "
                         "sectors per feed; synthesis costs ~50 ms/sector "
                         "of host CPU, which cannot feed a radar's rate "
                         "live on a small host — a real radar streams "
                         "captured samples).  0 = synthesise every sector")
    ap.add_argument("--zdb-tol", type=float, default=1e-4,
                    help="rel-L2 bound per sampled label (CPU fp32 "
                         "floor ~6e-8)")
    ap.add_argument("--base-port", type=int, default=23100)
    ap.add_argument("--out", default=None,
                    help="append the summary record to this JSON file")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CPU run: 2 feeds, short soak, mxu — checks "
                         "the harness plumbing, the rates are meaningless")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a jax.profiler trace with every executor "
                         "stage annotated, plus DIR/host_intervals.json "
                         "for tools/trace_summary.py --overlap — the "
                         "runtime overlap evidence")
    ap.add_argument("--producer-nice", type=int, default=0,
                    help="run producers at this niceness.  In production "
                         "the producers are REMOTE radars; on the "
                         "single-host test bench they contend with the "
                         "executor for the same cores, so de-prioritising "
                         "them models 'the wire arrives from outside' "
                         "while still pacing real datagrams")
    ap.add_argument("--stub-device", action="store_true",
                    help="replace the device step with an instant host "
                         "stub: measures the REAL executor's host path "
                         "(ingest reassembly, SIMD decode, queue, batch "
                         "stack, egress, volume) at rate with the "
                         "card out of the loop (see module "
                         "docstring).  Oracle pinning is skipped")
    args = ap.parse_args()
    if args.feeds < 2:
        # the teeth probe pins feed k against feed (k+1) % feeds, and the
        # executor only emits per-feed stats with >1 transport — a 1-feed
        # run would read its own oracle as "contamination" and then
        # KeyError; the tool is explicitly multi-feed
        ap.error("--feeds must be >= 2 (the soak is a multi-feed "
                 "consolidation check; use `cli stream` for one feed)")
    if args.stub_device and args.device_decode:
        ap.error("--stub-device has no device to decode on; drop "
                 "--device-decode (host decode is part of what the "
                 "stub run measures)")
    if args.stub_device:
        # the host path alone: keep the card out of the loop
        os.environ["JAX_PLATFORMS"] = "cpu"
    if args.smoke:
        args.feeds = 2
        args.duration = 3.0
        args.rate = 4.0
        args.batch = 2
        args.method = "mxu"
        args.verify_samples = 2
        os.environ["JAX_PLATFORMS"] = "cpu"

    import jax
    import numpy as np

    from wrp_tpu import DEFAULT_CONFIG, oracle
    from wrp_tpu.device import enable_compile_cache
    from wrp_tpu.oracle import produce_sector_iq
    from wrp_tpu.io.udp import UdpIngest
    from wrp_tpu.pipeline import DEFAULT_METHOD
    from wrp_tpu.runtime import StreamingExecutor, VolumeScan, \
        configure_logging

    args.method = args.method or DEFAULT_METHOD
    enable_compile_cache()
    configure_logging("info")   # progress lines make a hung run diagnosable

    # a whole sector is a 6.3 MB datagram burst; the default
    # net.core.rmem_max (4.2 MB) cannot hold even one — RAISE it when we
    # may (root), never lower an administrator's larger setting, else
    # UdpIngest's clamp warning tells the operator.  NB this is a
    # host-global sysctl and it is deliberately NOT restored on exit:
    # concurrent/subsequent receivers need it too, and logging the
    # change keeps the side effect visible to the operator.
    try:
        with open("/proc/sys/net/core/rmem_max") as f:
            cur = int(f.read().strip())
        if cur < (1 << 27):
            with open("/proc/sys/net/core/rmem_max", "w") as f:
                f.write(str(1 << 27))
            print(f"raised net.core.rmem_max {cur} -> {1 << 27} "
                  "(host-global, not restored on exit)", file=sys.stderr)
    except (OSError, ValueError):
        pass

    cfg = DEFAULT_CONFIG
    workdir = args.workdir or tempfile.mkdtemp(prefix="wrp_soak_")
    os.makedirs(workdir, exist_ok=True)
    sectors_per_feed = int(args.rate * args.duration)
    feed_seed = [1000 + k for k in range(args.feeds)]

    # udp + zmq mix.  The v1 per-pulse-row UDP framing (the reference's
    # wire) costs ~20 ms/sector of syscalls on EACH side (1025 datagrams
    # per sector), i.e. ~40% of a core per live feed at a real radar's
    # rate — so the udp feed count is a flag sized to the host, and the
    # remaining feeds ride the v2 whole-sector zmq wire (~4 ms/sector).
    # The consolidation contract is transport-agnostic either way
    # (uniform recv_sector + IngestStats).
    kinds = ["udp" if k < args.udp_feeds else "zmq"
             for k in range(args.feeds)]
    transports = []
    producer_cmds = []
    for k, kind in enumerate(kinds):
        port = args.base_port + k
        cmd = [sys.executable, "-m", "wrp_tpu.cli", "produce",
               "--transport", kind, "--sectors", str(sectors_per_feed),
               "--rate", str(args.rate), "--headers",
               "--per-sector-seed", "--seed", str(feed_seed[k])]
        if args.pool:
            cmd += ["--pool", str(args.pool)]
        if kind == "udp":
            transports.append(UdpIngest(cfg, port=port,
                                        timeout_s=args.timeout))
            cmd += ["--ingest-port", str(port)]
        else:
            from wrp_tpu.io.zmq_io import ZmqIngest

            transports.append(ZmqIngest(
                cfg, endpoint=f"tcp://127.0.0.1:{port}",
                timeout_ms=int(args.timeout * 1e3)))
            cmd += ["--zmq-bind", f"tcp://*:{port}"]
        producer_cmds.append(cmd)

    volumes = [VolumeScan(cfg, os.path.join(workdir, f"feed{k}.npz"))
               for k in range(args.feeds)]

    producers = []
    # producers never touch the device: pin them to the CPU so only
    # this process opens the card
    prod_env = dict(os.environ, JAX_PLATFORMS="cpu")

    def start_producers():
        # launched from on_ready: the chain is compiled and every ingest
        # thread is listening, so the wire never outruns the warmup
        # `nice -n N` prefix, not preexec_fn: preexec_fn forces the
        # fork() spawn path, which JAX (multithreaded) warns may
        # deadlock; the prefix keeps posix_spawn
        prefix = (["nice", "-n", str(args.producer_nice)]
                  if args.producer_nice else [])
        for k, cmd in enumerate(producer_cmds):
            logf = open(os.path.join(workdir, f"producer{k}.err"), "wb")
            producers.append(subprocess.Popen(
                prefix + cmd, stdout=logf, stderr=logf, env=prod_env,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))))
            logf.close()

    processor = None
    publish = None
    if args.stub_device:
        # instant host stub: the executor's compute slot costs ~nothing,
        # so every measured millisecond is HOST work — the reference's
        # casc4.prof question ("does the host side keep up at rate?")
        # asked of wrp_tpu's own runtime.  Products are stub zeros;
        # numerical parity is pinned by the non-stub soak records.
        stub_out = np.zeros((args.batch, cfg.num_output_bins), np.float32)

        def processor(planar):  # noqa: F811 — the stub step
            return stub_out, stub_out

        # egress ON: the v1 result wire's send syscalls belong in the
        # host-path measurement (read_single.cc:510-520 topology); the
        # frames go to an unlistened loopback port (unconnected sendto
        # — no consumer required, no ICMP error surfaced)
        from wrp_tpu.io.udp import UdpEgress

        publish = UdpEgress(cfg, zdb_port=args.base_port + 900,
                            zdr_port=args.base_port + 901, extended=True)
    ex = StreamingExecutor(
        cfg, transport=transports, publish=publish, batch=args.batch,
        method=args.method, device_decode=args.device_decode,
        processor=processor,
        volume=volumes, checkpoint_every_s=None,
        # generous idle window: producer startup (interpreter + jax
        # import + pool pre-encode, ~50 ms/sector) happens after
        # on_ready, launches serialise on a one-core host, and under a
        # loaded box the interpreter+import alone can take tens of
        # seconds per producer (a 20 s budget flaked the smoke test
        # under two spinners: 0 sectors before the idle limit).  The
        # cost of the slack is idle-drain wall time after EOF, never
        # the measured rates (span is first-to-last batch tick).
        idle_limit=max(5, math.ceil((90.0 + 0.06 * args.pool * args.feeds)
                                    / args.timeout)),
        on_ready=start_producers,
    )
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        ex.timers.enable_intervals(annotate=True)
        jax.profiler.start_trace(args.trace)
    t0 = time.monotonic()
    cpu0 = time.process_time()     # all executor threads' CPU
    stats = ex.run()
    executor_cpu_s = time.process_time() - cpu0
    if args.trace:
        jax.profiler.stop_trace()
        ipath = os.path.join(args.trace, "host_intervals.json")
        with open(ipath, "w") as f:
            json.dump(ex.timers.intervals, f)
        print(f"trace written to {args.trace} (host intervals: {ipath})",
              file=sys.stderr)
    # active span: first batch completion -> last batch completion.
    # Wall-clock minus warmup would still include producer startup and
    # the idle-drain tail (idle_limit * timeout after the wire goes
    # quiet), deflating every rate by tens of percent.
    span_s = ex.throughput.last_tick - ex.throughput.first_tick
    if span_s <= 0:   # degenerate single-batch run
        span_s = time.monotonic() - t0 - stats["timers"].get(
            "compute/warmup_compile", {}).get("total_s", 0.0)
    rcs = [p.wait(timeout=60) for p in producers]
    if any(rcs):
        sys.exit(f"producer exit codes {rcs} (logs in {workdir})")

    # ---- contamination check: each feed's volume vs ITS oracle --------
    rng = np.random.default_rng(2024)
    failures = []
    per_feed = []
    period = cfg.num_sectors * cfg.num_elevations
    for k in range(args.feeds):
        vol = volumes[k]
        if args.stub_device:
            # products are stub values — coverage/labels still prove the
            # batching routed every sector to its own feed's volume, but
            # there is nothing numerical to pin
            fstats = stats["feeds"][k]
            tr = fstats["transport"]
            lat = fstats["latency_ms"] or {}
            row = {
                "feed": k, "kind": kinds[k],
                "processed_sectors": fstats["processed_sectors"],
                "sent_sectors": sectors_per_feed,
                "sectors_per_second": round(
                    fstats["processed_sectors"] / span_s, 2),
                "p50_ms": lat.get("p50_ms"), "p99_ms": lat.get("p99_ms"),
                "drops": (tr.get("dropped_sectors", 0)
                          + tr.get("dropped_datagrams", 0)),
                "coverage_sectors": int(vol.coverage.sum()),
                "verify_labels": 0,
                "verify_rel_l2_max": None,
            }
            per_feed.append(row)
            print(json.dumps(row), flush=True)
            continue
        covered = np.argwhere(vol.coverage)
        # prefer single-occurrence labels: a label sent more than once
        # (soaks longer than one volume period) whose LAST occurrence
        # was dropped would hold an earlier occurrence's products, and
        # the last-k oracle would misread that drop as contamination
        once = np.array([
            [s, e] for s, e in covered
            if (s + cfg.num_sectors * e) + period >= sectors_per_feed
        ])
        candidates = once if len(once) else covered
        samples = candidates[rng.choice(
            len(candidates),
            min(args.verify_samples, len(candidates)), replace=False)]
        errs = []
        teeth_checked = False    # one wrong-feed probe PER FEED
        for s, e in samples:
            klast = last_k_for_label(int(s), int(e), sectors_per_feed,
                                     cfg.num_sectors, cfg.num_elevations)
            if args.pool:
                klast = klast % args.pool    # replay pool: entry k % N
            iq = produce_sector_iq(cfg, feed_seed[k], klast)
            zdb64, _ = oracle.process_sector(iq, cfg)
            err = oracle.relative_l2(zdb64, vol.data[0, :, s, e])
            errs.append(float(err))
            if not err < args.zdb_tol:
                failures.append({"feed": k, "sector": int(s),
                                 "elevation": int(e), "rel_l2": float(err)})
            if not teeth_checked:
                # the check must DETECT contamination, not just pass:
                # the same label against a neighbour feed's oracle
                wrong = produce_sector_iq(
                    cfg, feed_seed[(k + 1) % args.feeds], klast)
                zdb_wrong, _ = oracle.process_sector(wrong, cfg)
                cross = oracle.relative_l2(zdb_wrong, vol.data[0, :, s, e])
                # zdb is log-domain: two noise sectors share the gain
                # ramp, so a wrong feed reads ~1e-2 rel-L2 — far above
                # tol but nowhere near O(1); demand a decade of margin
                if not cross > 10 * args.zdb_tol:
                    failures.append({"feed": k, "teeth": float(cross)})
                teeth_checked = True
        fstats = stats["feeds"][k]
        tr = fstats["transport"]
        drops = (tr.get("dropped_sectors", 0)
                 + tr.get("dropped_datagrams", 0))
        lat = fstats["latency_ms"] or {}
        row = {
            "feed": k, "kind": kinds[k],
            "processed_sectors": fstats["processed_sectors"],
            "sent_sectors": sectors_per_feed,
            "sectors_per_second": round(
                fstats["processed_sectors"] / span_s, 2),
            "p50_ms": lat.get("p50_ms"), "p99_ms": lat.get("p99_ms"),
            "drops": drops,
            "verify_labels": len(samples),
            "verify_rel_l2_max": max(errs) if errs else None,
        }
        per_feed.append(row)
        print(json.dumps(row), flush=True)

    record = {
        "metric": "consolidation_soak",
        "feeds": args.feeds,
        "kinds": kinds,
        "duration_s": round(span_s, 1),
        "rate_per_feed": args.rate,
        "method": "stub" if args.stub_device else args.method,
        # processor overrides take planar f32, so the stub run pays the
        # f32 decode (decode_iq) — HEAVIER than the built-in step's
        # int16 decode: the measured host ceiling is a conservative
        # bound for the production deployment
        "decode": "host-f32" if args.stub_device
        else ("device" if args.device_decode else "host-i16"),
        "device_decode": args.device_decode,
        "batch": args.batch,
        "backend": "stub" if args.stub_device
        else jax.devices()[0].platform,
        "host_cores": os.cpu_count(),
        "producer_nice": args.producer_nice,
        "total_sectors": stats["processed_sectors"],
        "total_sectors_per_second": round(
            stats["processed_sectors"] / span_s, 2),
        # the reconciliation numbers for DESIGN.md §6's per-core
        # arithmetic: what the EXECUTOR process (ingest threads + batch
        # loop + egress + volume) actually spent per sector, and what
        # fraction of one core that was over the active span
        "executor_cpu_s": round(executor_cpu_s, 2),
        "executor_cpu_ms_per_sector": round(
            1e3 * executor_cpu_s / max(1, stats["processed_sectors"]), 3),
        "executor_core_fraction": round(executor_cpu_s / span_s, 3),
        # per-stage wall-time attribution (StageTimers): where the host
        # path actually spends its time — recv vs decode vs batch staging
        # vs fetch vs egress
        "timers": stats["timers"],
        "latency_ms": stats["latency_ms"],
        "per_feed": per_feed,
        "contamination_failures": failures,
        "smoke": args.smoke,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
                if not isinstance(existing, list):
                    existing = [existing]
        existing.append(record)
        with open(args.out, "w") as f:
            json.dump(existing, f, indent=1)
    if failures:
        sys.exit(1)
    total_drops = sum(r["drops"] for r in per_feed)
    if total_drops and not args.smoke:
        sys.exit(1)


if __name__ == "__main__":
    main()
