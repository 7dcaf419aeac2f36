"""Command-line entry points.

Mirrors the reference's executable surface (SURVEY.md section 2.1) as
subcommands of one CLI instead of sixteen separate mains:

  process  — single-shot file mode (reference read.cc / read_gpu.cu):
             IQ in, zdb/zdr out, per-stage dumps on request.
  stream   — streaming processor (reference gpu_1fp_streamcasc.cu v1 wire
             on UDP, rpv2.cu v2 wire on ZMQ), flags instead of the
             reference's hardcoded ports and NSTREAMS argv.
  produce  — replay/synthesise sectors onto the wire (the external
             producer of the reference's localhost topology).
  consume  — receive and print result frames (visualiser stand-in).

Usage: python -m wrp_tpu.cli <subcommand> --help
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np


def _add_common(p):
    from .pipeline import DEFAULT_METHOD, METHODS

    p.add_argument("--method", default=DEFAULT_METHOD, choices=METHODS,
                   help=f"chain formulation (default {DEFAULT_METHOD}, the "
                        "fastest measured on the GPU; PERF.md)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--structured-logs", action="store_true")


def _cfg_from_args(args):
    """DEFAULT_CONFIG with the --channels override applied.

    --channels 2 is the production profile the reference actually ran in
    its best-published era (hh+vv only: read.cc:61-62, and even the
    3-channel ingest never used vh in the products, read_single.cc:
    496-498): a 2-channel wire (8 B/sample instead of 12) and a
    2-channel chain — ~1/3 less host decode, H2D, and matmul work per
    sector for identical zdb/zdr."""
    from .config import DEFAULT_CONFIG

    ch = getattr(args, "channels", None)
    if ch and ch != DEFAULT_CONFIG.num_channels:
        import dataclasses

        return dataclasses.replace(
            DEFAULT_CONFIG, num_channels=ch).validate()
    return DEFAULT_CONFIG


def cmd_process(args):
    from . import oracle
    from .config import DEFAULT_CONFIG
    from .device import enable_compile_cache
    from .pipeline import SectorProcessor
    from .io import codec
    from .io.files import read_ascii_iq, write_ascii_matrix

    enable_compile_cache()
    cfg = DEFAULT_CONFIG
    if args.input == "synthetic":
        iq = oracle.synthetic_iq(cfg, kind="noise", seed=args.seed)
        planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    elif args.input == "-" or args.input.endswith(".altb"):
        # reference-era ASCII IQ capture (read.cc:106-123 stdin format):
        # "<i> <q>" pairs, all hh then all vv — a 2-channel sector
        import dataclasses

        stream = sys.stdin if args.input == "-" else open(args.input)
        iq = read_ascii_iq(stream, cfg.m, cfg.n, channels=2)
        if stream is not sys.stdin:
            stream.close()
        cfg = dataclasses.replace(cfg, num_channels=2)
        planar = np.stack([iq.real, iq.imag], 1).astype(np.float32)
    elif args.input.endswith(".npy"):
        planar = np.load(args.input)
    else:  # raw wire bytes
        planar = codec.decode_iq(open(args.input, "rb").read(), cfg)

    if args.dump_stages:
        # The reference's staged-golden methodology (SURVEY.md section 4):
        # write every stage boundary as XXname.altb files.
        import jax.numpy as jnp

        from .constants import PipelineConstants
        from . import pipeline as pl_mod

        consts = PipelineConstants.build(cfg)
        iq_c = jnp.asarray((planar[:, 0] + 1j * planar[:, 1]), jnp.complex64)
        stages = {k: np.asarray(v)
                  for k, v in pl_mod.all_stages(iq_c, consts).items()}
        from pathlib import Path

        outdir = Path(args.dump_stages)
        outdir.mkdir(parents=True, exist_ok=True)
        for name, arr in stages.items():
            if np.iscomplexobj(arr):
                arr = np.abs(arr)
            write_ascii_matrix(outdir / f"{name}.altb",
                               arr[0] if arr.ndim == 3 else arr)
        print(f"stage dumps -> {outdir}", file=sys.stderr)

    if args.timings:
        # per-stage wall-clock breakdown on the default device, the
        # read_gpu.cu tick/tock methodology (SURVEY.md section 5): force
        # each stage boundary with a device sync before timestamping.
        import jax
        import jax.numpy as jnp

        from . import pipeline as pl_mod
        from .constants import PipelineConstants

        consts = PipelineConstants.build(cfg)
        iq_c = jnp.asarray(planar[:, 0] + 1j * planar[:, 1], jnp.complex64)
        t_last = time.perf_counter()
        marks = []
        prev = None
        for name, fn in [
            ("01hamm", lambda x: pl_mod.stage01_window(
                x, jnp.asarray(consts.hamming, jnp.float32))),
            ("02fft1", pl_mod.stage02_range_fft),
            ("03fft2", pl_mod.stage03_doppler),
            ("04abs", pl_mod.stage04_power),
            ("07conv", lambda p: pl_mod.matched_filter_direct(
                p, consts.ma_taps)),
            ("08pow", pl_mod.stage08_pulse_sum),
        ]:
            prev = jax.block_until_ready(
                fn(iq_c if prev is None else prev))
            now = time.perf_counter()
            marks.append((name, (now - t_last) * 1e6))
            t_last = now
        for name, us in marks:
            print(f"stage {name}: {us:.0f} us", file=sys.stderr)

    proc = SectorProcessor(cfg, method=args.method)
    t0 = time.perf_counter()
    zdb, zdr = proc(planar[None])
    zdb, zdr = np.asarray(zdb)[0], np.asarray(zdr)[0]
    dt = time.perf_counter() - t0
    print(f"processing: {dt * 1e6:.0f} us", file=sys.stderr)
    if args.output:
        write_ascii_matrix(args.output, np.stack([zdb, zdr], 1))
    else:
        for a, b in zip(zdb, zdr):
            print(f"{a:g} {b:g}")
    return 0


def cmd_compare(args):
    """The reference's accuracy comparator (error.cpp:9-36) as a CLI:
    relative L2 over mutually finite values of two result files."""
    from . import oracle
    from .io.files import read_ascii_matrix, read_zdb_dump

    def load(path):
        if path.endswith(".bin"):
            # the reference's only .bin asset (out/cpu.bin) is a
            # native-endian zdb capture, NOT the BE wire serialisation
            return read_zdb_dump(path)
        return read_ascii_matrix(path)

    expected, actual = load(args.expected), load(args.actual)
    if expected.shape != actual.shape:
        print(f"shape mismatch: {expected.shape} vs {actual.shape}",
              file=sys.stderr)
        return 2
    err = oracle.relative_l2(expected, actual)
    print(json.dumps({"relative_l2": err, "threshold": args.threshold,
                      "pass": err <= args.threshold}))
    return 0 if err <= args.threshold else 1


def _ready_marker(path):
    """Readiness callback for --ready-file: touch the file once warmup
    compile is done and ingest is listening, so harnesses can gate the
    producer start on it instead of a guessed sleep."""
    if not path:
        return None

    def _touch():
        from pathlib import Path

        Path(path).touch()

    return _touch


def _open_volume(cfg, path):
    """Resume the volume scan from an existing checkpoint, else start
    fresh.  The checkpoint is self-describing; passing cfg enforces a
    geometry match so a stale file from a different radar can't silently
    corrupt the scan."""
    from pathlib import Path

    from .runtime import VolumeScan
    from .runtime.metrics import log

    if Path(path).exists():
        vs = VolumeScan.load(path, cfg)
        log.info("resuming volume scan from %s (%.1f%% covered)",
                 path, 100 * vs.fraction())
        if 0 < vs.fraction() < 1:
            # Bare v1 datagrams carry no sector/elevation: the executor's
            # implicit counters restart at (0, 0) after a restart, so a
            # headerless feed would RE-cover the start of the volume
            # instead of filling the gap.  Extended headers (produce
            # --headers) make resume position-exact.
            log.warning(
                "resume correctness depends on the wire carrying "
                "sector/elevation (extended ingest headers); a bare v1 "
                "feed restarts labeling at sector 0, elevation 0")
        return vs
    return VolumeScan(cfg, path)


def cmd_stream(args):
    import signal

    from .device import enable_compile_cache
    from .runtime import StreamingExecutor, configure_logging

    enable_compile_cache()
    configure_logging(args.log_level, args.structured_logs)
    # Service managers stop daemons with SIGTERM; route it through the
    # same graceful path as Ctrl-C (drain in-flight batch, save the
    # volume checkpoint, print stats) instead of dying mid-batch.
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    cfg = _cfg_from_args(args)
    if args.feed_port and args.transport == "zmq":
        # refuse rather than silently ignoring the user's feed list and
        # listening on one default endpoint (data loss, no diagnostic);
        # zmq feeds are endpoints, not ports — use --feed-endpoint
        print("--feed-port supports the udp and tcp transports only; "
              "zmq feeds are endpoints (--feed-endpoint)",
              file=sys.stderr)
        return 2
    if args.feed_endpoint and args.transport != "zmq":
        print("--feed-endpoint supports the zmq transport only; "
              "udp/tcp feeds are ports (--feed-port)", file=sys.stderr)
        return 2
    if args.feed_endpoint and len(set(args.feed_endpoint)) != len(
            args.feed_endpoint):
        # two SUBs on one endpoint would each receive EVERY message:
        # duplicated sectors under colliding per-feed labels
        print("duplicate --feed-endpoint values", file=sys.stderr)
        return 2
    feed_list = args.feed_port or args.feed_endpoint or []
    if args.feed_checkpoint:
        # explicit per-feed checkpoint paths: the supervisor keys
        # checkpoints by FEED so they survive regroups that move a feed
        # to a different host (runtime/supervisor.py); counts must match
        # or volumes would silently shift feeds
        if not feed_list or len(args.feed_checkpoint) != len(feed_list):
            print("--feed-checkpoint needs one path per --feed-port/"
                  "--feed-endpoint", file=sys.stderr)
            return 2
        if len(set(args.feed_checkpoint)) != len(args.feed_checkpoint):
            # two volumes over one file: last save() wins and silently
            # discards the other feed's sectors
            print("duplicate --feed-checkpoint paths", file=sys.stderr)
            return 2
    if args.device_decode and args.coordinator and not args.pulse_shard:
        # in the lock-step data-parallel mode the processor override
        # takes planar input; only the pulse-shard processor has a
        # wire-bytes path (each host decodes its pulse slice on the device)
        print("--device-decode with --coordinator needs --pulse-shard "
              "(the data-parallel lock-step processor takes planar "
              "input)", file=sys.stderr)
        return 2

    def make_ingest(ingest_cls):
        # multi-feed consolidation: one ingest per --feed-port, one
        # SHARED egress (result frames carry only sector/elevation, so a
        # merged wire is ambiguous across feeds — the per-feed
        # checkpoints are the authoritative volumes); single ingest on
        # --ingest-port otherwise
        if args.feed_port:
            return [ingest_cls(cfg, port=p, timeout_s=args.timeout)
                    for p in args.feed_port]
        kw = {}
        if ingest_cls.__name__ == "UdpIngest" and args.pulse_shard:
            # pulse-shard fleets co-host N readers of ONE broadcast
            # port; everywhere else a port collision should fail loudly
            kw["reuse_port"] = True
        return ingest_cls(cfg, port=args.ingest_port,
                          timeout_s=args.timeout, **kw)

    if args.transport == "udp":
        from .io.udp import UdpIngest, UdpEgress

        transport = make_ingest(UdpIngest)
        publish = UdpEgress(cfg, zdb_port=args.zdb_port,
                            zdr_port=args.zdr_port,
                            extended=args.extended_results)
    elif args.transport == "tcp":
        from .io.tcp import TcpIngest, TcpEgress

        transport = make_ingest(TcpIngest)
        publish = TcpEgress(cfg, port=args.result_port)
    else:
        from .io.zmq_io import ZmqIngest, ZmqEgress

        timeout_ms = int(args.timeout * 1e3) if args.timeout else None
        if args.feed_endpoint:
            # multi-feed consolidation over v2 wire: one SUB socket per
            # feed endpoint (a single SUB cannot attribute messages to
            # feeds), one shared PUB egress — same shape as udp/tcp
            transport = [ZmqIngest(cfg, endpoint=e, timeout_ms=timeout_ms)
                         for e in args.feed_endpoint]
        else:
            transport = ZmqIngest(cfg, endpoint=args.zmq_sub,
                                  timeout_ms=timeout_ms)
        publish = ZmqEgress(cfg, endpoint=args.zmq_pub)

    processor = None
    if args.pulse_shard and not args.coordinator:
        print("--pulse-shard needs the lock-step mesh (--coordinator)",
              file=sys.stderr)
        return 2
    from .parallel.sharded import SHARD_METHODS

    if args.pulse_shard and args.method not in SHARD_METHODS:
        print(f"--pulse-shard supports --method {', '.join(SHARD_METHODS)}"
              " (parallel/sharded.py)", file=sys.stderr)
        return 2
    if args.coordinator:
        # lock-step multi-host streaming: every host runs this command with
        # its own transport ports and --host-id; batches step collectively
        # over the global mesh (parallel/multihost.py).
        from .parallel.multihost import (MultiHostProcessor,
                                         PulseShardedProcessor,
                                         init_distributed)

        init_distributed(args.coordinator, args.num_hosts, args.host_id)
        if args.pulse_shard:
            processor = PulseShardedProcessor.build(
                cfg, batch=args.batch, method=args.method,
                device_decode=args.device_decode).step_local
        else:
            processor = MultiHostProcessor.build(
                cfg, per_host_batch=args.batch, method=args.method).step_local

    volume = None
    if args.feed_checkpoint:
        volume = [_open_volume(cfg, p) for p in args.feed_checkpoint]
    elif args.checkpoint:
        if isinstance(transport, list):
            # per-feed volumes: vol.npz -> vol.feed0.npz, vol.feed1.npz...
            from pathlib import Path

            base = Path(args.checkpoint)
            volume = [
                _open_volume(cfg, str(base.with_suffix(f".feed{k}.npz")))
                for k in range(len(transport))
            ]
        else:
            volume = _open_volume(cfg, args.checkpoint)
    ex = StreamingExecutor(
        cfg, transport=transport, publish=publish, batch=args.batch,
        method=args.method, debug_sync=args.debug_sync, volume=volume,
        device_decode=args.device_decode,
        max_sectors=args.max_sectors, idle_limit=args.idle_limit,
        processor=processor, lockstep=args.coordinator is not None,
        checkpoint_every_s=(None if args.checkpoint_every < 0
                            else args.checkpoint_every),
        # a peer that missed its recv timeout should show up in OUR logs
        # shortly after, not look like a silent hang
        stall_warning_s=max(10.0, 2.0 * (args.timeout or 0.0)),
        collective_timeout_s=args.collective_timeout,
        on_ready=_ready_marker(args.ready_file),
    )
    if args.trace:
        # runtime overlap evidence (the reference's prof/casc*.prof
        # analogue): a jax.profiler chrome trace with every executor
        # stage annotated, plus the raw host intervals for
        # tools/trace_summary.py --overlap
        import jax

        os.makedirs(args.trace, exist_ok=True)
        ex.timers.enable_intervals(annotate=True)
        jax.profiler.start_trace(args.trace)
    stats = ex.run()
    if args.trace:
        import jax

        jax.profiler.stop_trace()
        ipath = os.path.join(args.trace, "host_intervals.json")
        with open(ipath, "w") as f:
            json.dump(ex.timers.intervals, f)
        print(f"trace written to {args.trace} (host intervals: {ipath})",
              file=sys.stderr)
    if args.transport == "zmq" and publish is not None:
        # flush queued result frames before exit (bounded linger term);
        # udp/tcp writes complete synchronously in send()
        publish.close()
    if volume is not None and (args.checkpoint or args.feed_checkpoint):
        vols = volume if isinstance(volume, list) else [volume]
        for v in vols:
            v.save()
        cov = [v.fraction() for v in vols]
        stats["volume_coverage"] = cov if len(cov) > 1 else cov[0]
    print(json.dumps(stats, indent=2))
    if args.coordinator:
        # Bounded exit for the lock-step path.  With a dead peer, the
        # atexit jax.distributed.shutdown blocks on the coordination
        # handshake until the service's ~90 s fatal teardown kills the
        # process with rc 1 — AFTER all work and checkpoints are safely
        # on disk (the data-parallel step needs no cross-host
        # collective, so a survivor streams its own sectors to
        # completion regardless; parallel/multihost.py).  Attempt the
        # graceful shutdown — healthy meshes (and the coordinator
        # waiting for live clients) complete it in milliseconds — but
        # bound it with a hard-exit timer so a dead peer costs at most
        # `bound` seconds, not the fatal-teardown minute-and-a-half.
        import threading

        import jax

        sys.stdout.flush()
        sys.stderr.flush()
        bound = max(10.0, args.collective_timeout or 0.0)
        threading.Timer(bound, lambda: os._exit(0)).start()
        try:
            jax.distributed.shutdown()
        except Exception:
            pass
        os._exit(0)
    return 0


def cmd_supervise(args):
    """Coordinator-led failure recovery for the multi-host stream fleet
    (runtime/supervisor.py): on a worker death the surviving hosts are
    drained, the dead host's feeds are reassigned to survivors, and a
    smaller lock-step mesh relaunches from the per-feed checkpoints.
    The reference's dataflow (`rpv2.cu`) loses the whole in-memory
    volume in this scenario."""
    import signal
    from pathlib import Path

    from .device import visible_cards
    from .runtime import configure_logging
    from .runtime.supervisor import FeedSpec, Supervisor

    configure_logging(args.log_level, args.structured_logs)
    # service managers stop the supervisor with SIGTERM; route it to the
    # graceful path (stop the fleet, report "interrupted") like cmd_stream
    def _sigterm(_signo, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    ckdir = Path(args.checkpoint_dir)
    ckdir.mkdir(parents=True, exist_ok=True)
    if args.transport == "zmq":
        if args.feed_port:
            # refuse rather than silently dropping the --feed-port
            # feeds (same contract as cmd_stream's mismatch checks)
            print("--feed-port supports the udp and tcp transports "
                  "only; zmq feeds are endpoints (--feed-endpoint)",
                  file=sys.stderr)
            return 2
        if not args.feed_endpoint:
            print("zmq supervision needs --feed-endpoint (zmq feeds are "
                  "endpoints the workers' SUB sockets connect to)",
                  file=sys.stderr)
            return 2
        # checkpoint names derive from the endpoint (sanitized), so the
        # same feed maps to the same file across supervisor RESTARTS,
        # not just across generations
        feeds = [FeedSpec(port=None, endpoint=e,
                          checkpoint=ckdir / (
                              "feed-"
                              + re.sub(r"[^A-Za-z0-9_.-]+", "-", e)
                              + ".npz"))
                 for e in args.feed_endpoint]
    else:
        if args.feed_endpoint:
            print("--feed-endpoint supports the zmq transport only; "
                  "udp/tcp feeds are ports (--feed-port)",
                  file=sys.stderr)
            return 2
        if not args.feed_port:
            print(f"{args.transport} supervision needs --feed-port",
                  file=sys.stderr)
            return 2
        feeds = [FeedSpec(port=p, checkpoint=ckdir / f"feed{p}.npz")
                 for p in args.feed_port]
    try:
        sup = Supervisor(
            feeds, args.hosts if args.hosts is not None else len(feeds),
            transport=args.transport,
            batch=args.batch, method=args.method, timeout=args.timeout,
            collective_timeout=args.collective_timeout,
            target_sectors=args.target_sectors,
            max_generations=args.max_generations,
            regrow_after_s=args.regrow_after,
            zdb_port=args.zdb_port, zdr_port=args.zdr_port,
            result_port=args.result_port,
            ready_timeout_s=args.ready_timeout,
            state_file=args.state_file,
            log_dir=ckdir / "logs",   # postmortems of host deaths
            pulse_shard=args.pulse_shard,
            cards=visible_cards(),
            extra_args=(["--log-level", args.log_level]
                        + (["--device-decode"] if args.device_decode
                           else [])
                        + (["--channels", str(args.channels)]
                           if args.channels != 3 else [])),
        )
    except ValueError as e:          # usage errors, same contract as
        print(e, file=sys.stderr)    # the other subcommands
        return 2
    summary = sup.run()
    print(json.dumps(summary, indent=2))
    return 0 if summary["ok"] else 4


def cmd_volume(args):
    """Inspect / export a volume-scan checkpoint (the persistent form of
    the reference's in-memory result[2, 512, 143, 9] buffer, rpv2.cu:292)."""
    from .runtime import VolumeScan

    vs = VolumeScan.load(args.checkpoint)   # geometry is self-describing
    covered = vs.coverage
    info = {
        "coverage": round(vs.fraction(), 4),
        "sectors_covered": int(covered.sum()),
        "elevations_touched": int(covered.any(axis=0).sum()),
        "complete": vs.complete(),
    }
    if covered.any():
        # both products (read_single.cc:496-498): zdb = data[0], zdr = data[1]
        for name, plane in (("zdb", vs.data[0]), ("zdr", vs.data[1])):
            vals = plane[1:, covered]    # skip the always -inf/NaN bin 0
            finite = vals[np.isfinite(vals)]
            if finite.size:
                info[f"{name}_min"] = round(float(finite.min()), 2)
                info[f"{name}_max"] = round(float(finite.max()), 2)
                info[f"{name}_mean"] = round(float(finite.mean()), 2)
    print(json.dumps(info))
    if args.export:
        np.savez(args.export, zdb=vs.data[0], zdr=vs.data[1],
                 coverage=vs.coverage)
        print(f"exported -> {args.export}", file=sys.stderr)
    if args.export_ascii:
        # reference interop: one 99result-format file per covered sector
        # (lines of "zdb zdr", out/99result.cpu.out) so reference-era
        # tooling — or `cli compare` — can consume framework volumes
        from pathlib import Path

        from .io.files import write_ascii_matrix

        outdir = Path(args.export_ascii)
        outdir.mkdir(parents=True, exist_ok=True)
        n_files = 0
        for sec, elev in np.argwhere(covered):
            pair = np.stack([vs.data[0, :, sec, elev],
                             vs.data[1, :, sec, elev]], axis=1)
            write_ascii_matrix(outdir / f"s{int(sec):03d}e{int(elev)}.out",
                               pair)
            n_files += 1
        print(f"exported {n_files} sectors (99result format) -> {outdir}",
              file=sys.stderr)
    if args.render:
        from . import viz

        plane = {"zdb": 0, "zdr": 1}[args.product]
        field = np.array(vs.data[plane, :, :, args.elevation])
        field[:, ~vs.coverage[:, args.elevation]] = np.nan  # uncovered
        img = viz.render_ppi(field, size=args.render_size)
        viz.write_ppm(args.render, img)
        print(f"rendered {args.product} elevation {args.elevation} "
              f"-> {args.render}", file=sys.stderr)
    if args.render_all:
        from . import viz

        plane = {"zdb": 0, "zdr": 1}[args.product]
        img = viz.render_volume_mosaic(
            np.asarray(vs.data[plane]), vs.coverage,
            size=min(args.render_size, 256))
        viz.write_ppm(args.render_all, img)
        print(f"rendered {args.product} mosaic of "
              f"{vs.data.shape[-1]} cuts -> {args.render_all}",
              file=sys.stderr)
    return 0


def cmd_produce(args):
    from . import oracle
    from .io import codec
    from .oracle import produce_sector_iq

    cfg = _cfg_from_args(args)
    if args.transport == "udp":
        from .io.udp import UdpProducer

        producer = UdpProducer(cfg, host=args.host, port=args.ingest_port,
                               extended_headers=args.headers)
    elif args.transport == "tcp":
        from .io.tcp import TcpProducer

        producer = TcpProducer(cfg, host=args.host, port=args.ingest_port)
    else:
        from .io.zmq_io import ZmqProducer

        producer = ZmqProducer(cfg, endpoint=args.zmq_bind,
                               extended_headers=args.headers)
        time.sleep(args.connect_delay)  # PUB/SUB join grace

    replay_wire = None
    if args.input:
        # replay a reference-era ASCII IQ capture (read.cc stdin format)
        # onto the wire: 2 recorded channels, vh padded with zeros (the
        # reference's vh was never used in the products).  Encoded ONCE —
        # the constant sector re-encoding would otherwise cap the replay
        # rate at host codec speed.
        from .io.files import read_ascii_iq

        with open(args.input) as f:
            iq2 = read_ascii_iq(f, cfg.m, cfg.n, channels=2)
        replay = np.zeros(cfg.sector_shape, np.complex128)
        replay[:2] = iq2
        replay_wire = codec.encode_iq(replay, cfg)

    pool = None
    if args.pool:
        # pre-encoded replay pool: synthesising + encoding a sector costs
        # ~50 ms of host CPU, which cannot feed a real radar's 21.5
        # sectors/s live on a small host — so pay it up front for
        # args.pool distinct sectors and replay them cyclically (send is
        # ~3 ms).  Pool entry j uses the (seed, j) derivation, so a
        # verifier recomputes sector k's IQ as produce_sector_iq(cfg,
        # seed, k % pool) — per-sector-seed semantics, bounded memory.
        pool = [codec.encode_iq(produce_sector_iq(cfg, args.seed, j), cfg)
                for j in range(args.pool)]
    rng = np.random.default_rng(args.seed)
    sent = 0
    t_next = time.perf_counter()
    for k0 in range(args.sectors):
        k = args.start_sector + k0
        sector = k % cfg.num_sectors
        elevation = (k // cfg.num_sectors) % cfg.num_elevations
        if replay_wire is not None:
            wire = replay_wire
        elif pool is not None:
            wire = pool[k % args.pool]
        elif args.per_sector_seed:
            # sector k recomputable WITHOUT replaying the whole stream:
            # verification harnesses (tools/consolidation_soak.py) can
            # re-derive any sampled sector's IQ directly from (seed, k)
            # and pin the feed's stored products to its own fp64 oracle
            iq = produce_sector_iq(cfg, args.seed, k)
            wire = codec.encode_iq(iq, cfg)
        else:
            iq = (rng.integers(-8192, 8192, cfg.sector_shape)
                  + 1j * rng.integers(-8192, 8192, cfg.sector_shape))
            wire = codec.encode_iq(iq, cfg)
        producer.send_sector(wire, sector, elevation)
        sent += 1
        if args.rate:
            # absolute schedule, like a real radar: sector k goes out at
            # t0 + k/rate.  A relative sleep(1/rate) after each send
            # would add the send's own cost to every period and deliver
            # strictly below the requested rate (measured ~6% short for
            # the 6.3 MB zmq sends on the 1-core dev box)
            t_next += 1.0 / args.rate
            dt = t_next - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
    # flush before exit: a zmq PUB queues sends to an io thread, and a
    # producer exiting right away drops the queued tail (a whole sector
    # is 6.3 MB); close() blocks until delivered or the linger bound
    producer.close()
    print(f"sent {sent} sectors", file=sys.stderr)
    return 0


class _ResultAccumulator:
    """Accumulates received result frames into a VolumeScan checkpoint —
    the consumer as a real display endpoint instead of the reference's
    print-only stub (receive.cpp); pair with `cli volume --render` for a
    PPI image of what actually arrived over the wire."""

    def __init__(self, cfg, path):
        from .runtime import VolumeScan

        self.vs = VolumeScan(cfg, path)
        self._have: dict = {}

    def add(self, product: int, sector: int, elevation: int, values) -> None:
        cfg = self.vs.cfg
        if not (0 <= sector < cfg.num_sectors
                and 0 <= elevation < cfg.num_elevations):
            return
        vals = np.asarray(values, np.float32)
        if vals.shape != (cfg.num_output_bins,):
            return
        self.vs.data[product, :, sector, elevation] = vals
        seen = self._have.setdefault((sector, elevation), set())
        seen.add(product)
        if len(seen) == 2:   # covered once BOTH products arrived
            self.vs.coverage[sector, elevation] = True

    def save(self):
        p = self.vs.save()
        print(f"volume -> {p} (coverage {self.vs.fraction():.4f})",
              file=sys.stderr)


def cmd_consume(args):
    cfg = _cfg_from_args(args)
    acc = _ResultAccumulator(cfg, args.volume) if args.volume else None
    if args.transport == "udp":
        import select
        import socket
        import struct

        from .io import frames

        def bind(port):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", port))
            return s

        # v1 wire: zdb and zdr ride separate ports; the zdr socket is
        # only opened when accumulating (display counts zdb frames)
        socks = {bind(args.port or cfg.udp_zdb_port): 0}
        if acc is not None:
            socks[bind(args.zdr_port or cfg.udp_zdr_port)] = 1

        def drain_ready(wait_s):
            """One select slice; returns the number of zdb frames seen."""
            zdbs = 0
            ready, _, _ = select.select(list(socks), [], [], wait_s)
            for s in ready:
                buf, _ = s.recvfrom(65536)
                try:
                    sector, elev, values = frames.unpack_result_udp(buf)
                except (struct.error, ValueError):
                    # a runt datagram must not kill the consumer (and
                    # with --volume, lose everything accumulated so far)
                    print("dropped malformed result frame", file=sys.stderr)
                    continue
                product = socks[s]
                if product == 0:
                    tag = "" if elev is None else f" elev {elev}"
                    print(f"sector {sector}{tag}: {values[:4]} ...")
                    zdbs += 1
                if acc is not None:
                    # bare v1 frames carry no elevation
                    # (read_single.cc:510-520): accumulate those at cut 0;
                    # v1x frames (stream --extended-results) place exactly
                    acc.add(product, sector, elev or 0, values)
            return zdbs

        got = 0
        # rolling deadline on zdb PROGRESS (not mere traffic): zdr-only
        # or foreign datagrams must not keep an idle consumer alive
        deadline = time.monotonic() + args.timeout
        while got < args.count and time.monotonic() < deadline:
            n = drain_ready(0.25)
            if n:
                got += n
                deadline = time.monotonic() + args.timeout
        if acc is not None:
            # grace drain: the final sector's zdr frame may trail its zdb
            end = time.monotonic() + 0.5
            while time.monotonic() < end:
                drain_ready(0.1)
        for s in socks:
            s.close()
    else:
        if args.transport == "tcp":
            from .io.tcp import TcpResultConsumer

            consumer = TcpResultConsumer(cfg, port=args.port,
                                         timeout_s=args.timeout)
        else:
            from .io.zmq_io import ZmqResultConsumer

            consumer = ZmqResultConsumer(
                cfg, endpoint=args.zmq_sub,
                timeout_ms=int(args.timeout * 1e3))
        got = 0
        while got < args.count:
            item = consumer.recv()
            if item is None:
                break
            topic, sector, elevation, values = item
            print(f"{topic.decode()}: sector {sector} elev {elevation}: "
                  f"{values[:4]} ...")
            got += 1
            if acc is not None:
                acc.add(0 if topic == cfg.zmq_zdb_topic else 1,
                        sector, elevation, values)
        consumer.close()
    if acc is not None:
        acc.save()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="wrp_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("process", help="single-shot file processing")
    _add_common(p)
    p.add_argument("--input", default="synthetic",
                   help="'synthetic', raw wire .bin, planar .npy, ASCII IQ "
                        ".altb, or '-' for ASCII IQ on stdin (read.cc "
                        "format)")
    p.add_argument("--output", default=None, help="99result-format output")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dump-stages", default=None, metavar="DIR",
                   help="write per-stage .altb dumps (golden methodology)")
    p.add_argument("--timings", action="store_true",
                   help="per-stage wall-clock breakdown (read_gpu.cu "
                        "tick/tock equivalent)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("compare",
                       help="relative-L2 comparator (error.cpp equivalent)")
    p.add_argument("expected")
    p.add_argument("actual")
    p.add_argument("--threshold", type=float, default=1e-4)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("stream", help="streaming processor")
    _add_common(p)
    p.add_argument("--channels", type=int, default=3, choices=[2, 3],
                   help="wire/chain channel count: 3 = hh+vv+vh (the "
                        "reference's wire) or 2 = hh+vv, the production "
                        "profile of its best-published era (read.cc:61-62"
                        ") — 1/3 less decode, wire, and device work per sector, "
                        "identical products (vh never reaches zdb/zdr)")
    p.add_argument("--transport", default="udp", choices=["udp", "tcp", "zmq"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--ingest-port", type=int, default=None)
    p.add_argument("--feed-port", type=int, action="append", default=None,
                   metavar="PORT",
                   help="udp/tcp transports: repeat to multiplex several "
                        "radar feeds into one processor (one ingest per "
                        "port, per-feed stats and checkpoints); overrides "
                        "--ingest-port")
    p.add_argument("--feed-endpoint", action="append", default=None,
                   metavar="ENDPOINT",
                   help="zmq transport: repeat to multiplex several v2 "
                        "feeds into one processor (one SUB socket per "
                        "endpoint, per-feed stats and checkpoints); "
                        "overrides --zmq-sub")
    p.add_argument("--zdb-port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None)
    p.add_argument("--zmq-sub", default=None)
    p.add_argument("--zmq-pub", default=None)
    p.add_argument("--result-port", type=int, default=None,
                   help="tcp transport: result collector port")
    p.add_argument("--checkpoint", default=None,
                   help="volume .npz path; resumes coverage if it exists")
    p.add_argument("--feed-checkpoint", action="append", default=None,
                   metavar="PATH",
                   help="explicit per-feed volume .npz (repeat once per "
                        "--feed-port/--feed-endpoint, same order) — "
                        "checkpoints keyed by feed so a supervisor can "
                        "move feeds between hosts across regroups; "
                        "overrides --checkpoint naming")
    p.add_argument("--checkpoint-every", type=float, default=30.0,
                   help="periodic save interval in seconds (0 saves "
                        "every batch; negative disables periodic saves)")
    p.add_argument("--extended-results", action="store_true",
                   help="udp transport: emit v1x result frames carrying "
                        "the elevation (consumers reconstruct full "
                        "volumes; default stays v1 wire-compatible)")
    p.add_argument("--debug-sync", action="store_true",
                   help="validate numerics every batch (rpv2 gpuErrchk mode)")
    p.add_argument("--device-decode", action="store_true",
                   help="ship RAW wire bytes and decode them on the "
                        "device (ops/device_codec) — frees the host "
                        "decode cores at some device-time cost")
    p.add_argument("--max-sectors", type=int, default=None)
    p.add_argument("--idle-limit", type=int, default=None,
                   help="exit after N consecutive idle recv timeouts")
    p.add_argument("--ready-file", default=None,
                   help="touch this file once warmup compile is done and "
                        "ingest is listening (harness readiness gate)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a jax.profiler trace with every executor "
                        "stage annotated plus DIR/host_intervals.json; "
                        "summarise with tools/trace_summary.py DIR "
                        "--overlap (the runtime overlap evidence)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of host 0 — enables lock-step "
                        "multi-host streaming over one global mesh")
    p.add_argument("--num-hosts", type=int, default=1)
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--pulse-shard", action="store_true",
                   help="lock-step mode: sequence parallelism ACROSS "
                        "hosts — every host ingests the same broadcast "
                        "wire and computes a 1/N pulse-column slice of "
                        "every sector; the transpose-FFT all_to_all/"
                        "all_gather cross the host boundary "
                        "(parallel/multihost.py PulseShardedProcessor). "
                        "Default splits the sector STREAM instead "
                        "(data-parallel, zero cross-host collectives)")
    p.add_argument("--collective-timeout", type=float, default=None,
                   metavar="S",
                   help="lock-step mode: bound every wait — when a "
                        "collective step blocks past S (a peer host "
                        "died), or this host makes no batch progress for "
                        "S (its own feed died, wedging the peers), save "
                        "the volume checkpoint, print stats to stderr, "
                        "and exit 3 instead of hanging forever; restart "
                        "every host with --checkpoint to resume.  Set S "
                        "comfortably above the expected sector gap")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser(
        "supervise",
        help="launch + watch a lock-step stream fleet; regroup on death")
    _add_common(p)
    p.add_argument("--channels", type=int, default=3, choices=[2, 3],
                   help="wire/chain channel count: 3 = hh+vv+vh (the "
                        "reference's wire) or 2 = hh+vv, the production "
                        "profile of its best-published era (read.cc:61-62"
                        ") — 1/3 less decode, wire, and device work per sector, "
                        "identical products (vh never reaches zdb/zdr)")
    p.add_argument("--transport", default="udp",
                   choices=["udp", "tcp", "zmq"])
    p.add_argument("--feed-port", type=int, action="append", default=None,
                   metavar="PORT",
                   help="udp/tcp: one radar feed per flag")
    p.add_argument("--feed-endpoint", action="append", default=None,
                   metavar="ENDPOINT",
                   help="zmq: one v2 feed (PUB endpoint to subscribe) "
                        "per flag; pair with `produce --headers` so "
                        "sectors carry labels — the bare v2 wire is "
                        "positional and cannot resume soundly after a "
                        "regroup")
    p.add_argument("--result-port", type=int, default=None,
                   help="tcp transport: result collector port")
    p.add_argument("--hosts", type=int, default=None,
                   help="initial worker-process count (default: one per "
                        "feed)")
    p.add_argument("--pulse-shard", action="store_true",
                   help="redundant-fleet mode: exactly ONE broadcast "
                        "feed (udp broadcast / zmq pub) that EVERY host "
                        "ingests whole; workers run `stream "
                        "--pulse-shard` (each computes a 1/N pulse "
                        "slice, full products everywhere), a host death "
                        "re-slices automatically, and the freshest "
                        "per-host volume copy seeds each generation — "
                        "no processed sector is lost while any host "
                        "survives")
    p.add_argument("--checkpoint-dir", required=True,
                   help="per-feed volumes land here as feed<PORT>.npz and "
                        "FOLLOW the feed across regroups")
    p.add_argument("--target-sectors", type=int, default=None,
                   help="stop successfully once every feed's checkpoint "
                        "holds N sectors")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--device-decode", action="store_true",
                   help="workers decode wire bytes on the device (see "
                        "stream --device-decode)")
    p.add_argument("--collective-timeout", type=float, default=30.0)
    p.add_argument("--ready-timeout", type=float, default=300.0,
                   metavar="S",
                   help="a generation whose warmup (mesh join + "
                        "compile) exceeds S without any worker dying "
                        "ends the run with reason ready_timeout; raise "
                        "on hardware with slow cold compiles")
    p.add_argument("--max-generations", type=int, default=8)
    p.add_argument("--regrow-after", type=float, default=None,
                   metavar="S",
                   help="elastic re-growth: after a shrink, once the "
                        "smaller fleet has been ready and healthy S "
                        "seconds, probe one host back up toward the "
                        "starting count (a probe that dies in warmup "
                        "falls back and waits another window)")
    p.add_argument("--zdb-port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None)
    p.add_argument("--state-file", default=None,
                   help="append one JSON line per supervisor event "
                        "(launch/ready/host_death/regroup/grow/done)")
    p.set_defaults(fn=cmd_supervise)

    p = sub.add_parser("volume", help="inspect/export a volume checkpoint")
    p.add_argument("checkpoint", help="volume .npz path")
    p.add_argument("--export", default=None, help="write plain .npz arrays")
    p.add_argument("--export-ascii", default=None, metavar="DIR",
                   help="write one 99result-format ASCII file per covered "
                        "sector ('zdb zdr' lines, the reference's "
                        "out/99result.*.out format) for reference-era "
                        "tooling and `cli compare`")
    p.add_argument("--render", default=None, metavar="OUT.ppm",
                   help="render a PPI image of one elevation cut (binary "
                        "PPM, no imaging deps)")
    p.add_argument("--render-all", default=None, metavar="OUT.ppm",
                   help="render ALL elevation cuts as one tiled mosaic "
                        "with a shared color scale")
    p.add_argument("--product", default="zdb", choices=["zdb", "zdr"])
    p.add_argument("--elevation", type=int, default=0)
    p.add_argument("--render-size", type=int, default=512)
    p.set_defaults(fn=cmd_volume)

    p = sub.add_parser("produce", help="replay sectors onto the wire")
    p.add_argument("--channels", type=int, default=3, choices=[2, 3],
                   help="wire/chain channel count: 3 = hh+vv+vh (the "
                        "reference's wire) or 2 = hh+vv, the production "
                        "profile of its best-published era (read.cc:61-62"
                        ") — 1/3 less decode, wire, and device work per sector, "
                        "identical products (vh never reaches zdb/zdr)")
    p.add_argument("--transport", default="udp", choices=["udp", "tcp", "zmq"])
    p.add_argument("--sectors", type=int, default=143)
    p.add_argument("--start-sector", type=int, default=0,
                   help="label offset: resume a feed mid-volume (the "
                        "sector/elevation counters start here)")
    p.add_argument("--rate", type=float, default=0.0, help="sectors/s cap")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--per-sector-seed", action="store_true",
                   help="derive sector k's IQ from (seed, k) instead of "
                        "one sequential stream — any sector is then "
                        "independently recomputable by a verifier "
                        "(tools/consolidation_soak.py contamination "
                        "checks)")
    p.add_argument("--pool", type=int, default=0, metavar="N",
                   help="pre-encode N distinct (seed, j)-derived sectors "
                        "and replay them cyclically — sector k's IQ is "
                        "pool entry k %% N.  Decouples the wire rate from "
                        "the ~50 ms/sector synthesis cost (a real radar "
                        "streams captured samples; it does not synthesise)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--ingest-port", type=int, default=None)
    p.add_argument("--zmq-bind", default="tcp://*:5563")
    p.add_argument("--headers", action="store_true",
                   help="extended ingest headers (drop detection)")
    p.add_argument("--input", default=None, metavar="IQ.altb",
                   help="replay a captured ASCII IQ sector (read.cc "
                        "format, 2 channels) instead of synthesising")
    p.add_argument("--connect-delay", type=float, default=0.5)
    p.set_defaults(fn=cmd_produce)

    p = sub.add_parser("consume", help="receive result frames")
    p.add_argument("--channels", type=int, default=3, choices=[2, 3],
                   help="wire/chain channel count: 3 = hh+vv+vh (the "
                        "reference's wire) or 2 = hh+vv, the production "
                        "profile of its best-published era (read.cc:61-62"
                        ") — 1/3 less decode, wire, and device work per sector, "
                        "identical products (vh never reaches zdb/zdr)")
    p.add_argument("--volume", default=None, metavar="OUT.npz",
                   help="accumulate received zdb/zdr frames into a volume "
                        "checkpoint (then: cli volume OUT.npz --render)")
    p.add_argument("--transport", default="udp", choices=["udp", "tcp", "zmq"])
    p.add_argument("--count", type=int, default=10)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--zdr-port", type=int, default=None,
                   help="udp --volume: zdr result port (defaults to the "
                        "config port; set alongside a custom --port)")
    p.add_argument("--zmq-sub", default="tcp://localhost:5564")
    p.set_defaults(fn=cmd_consume)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
