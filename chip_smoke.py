#!/usr/bin/env python
"""Quickest proof that the radar chain runs compiled on the GPU.

    python chip_smoke.py                # one card: device, parity, stream,
                                        # decode
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

One card, each phase printing one JSON line:

* device — JAX's default device must be a GPU; the card's name and power
  limit as nvidia-smi gives them.
* parity — every formulation against the fp64 oracle at full width
  (wrp_tpu.parity: zdb, zdr and the adversarial clip-bin field, with the
  dot precision named), the on-device wire decode against the host
  decode on the same sectors, and the memory analysis of the batch-128
  flagship step.
* stream — the served path: `cli stream` over UDP, run in this process
  (the one that holds the card), fed by `cli produce --per-sector-seed
  --headers --pool` at one radar's rate and read back by `cli consume
  --volume` (both children on the CPU).  Two elevation cuts (286
  sectors) with zero drops, the consumer's volume equal to the
  processor's, and sampled sectors equal to the oracle recomputed from
  (seed, k mod pool).
* decode — the same stream with --device-decode on 64 sectors.

Four cards (--four-cards), each phase against the single-card route on
the same sectors:

* lockstep — four `cli stream --num-hosts 4` processes, one card each.
* mesh — the data-parallel step on a 4x1 mesh and the pulse-shard
  all_to_all step on a 1x4 mesh, planar and wire input.

The card's name and power limit come on the line before the last; the
last line is {"ok": true, "device": {"platform", "kind", "count"}}.  Any
failed phase exits non-zero, without that line; so does a run without a
GPU or without the rest of the repository beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RADAR_RATE = 143 * 9 / 60.0     # sectors/s: one volume scan a minute


@dataclasses.dataclass
class SmokeConfig:
    """Sizes of the smoke's phases (the defaults are the card's run)."""

    channels: int = 3
    batch: int = 128            # the step whose memory analysis prints
    stream_batch: int = 16
    sectors: int = 286          # two elevation cuts of 143 sectors
    decode_sectors: int = 64
    lockstep_sectors: int = 32  # per host
    lockstep_batch: int = 8
    mesh_batch: int = 16
    rate: float = RADAR_RATE
    pool: int = 32              # distinct pre-encoded sectors per producer
    seed: int = 7
    samples: int = 6            # oracle-checked sectors per stream
    timeout_s: float = 600.0    # bound on every child process
    workdir: Path | None = None

    def radar(self):
        from wrp_tpu import DEFAULT_CONFIG

        return dataclasses.replace(DEFAULT_CONFIG,
                                   num_channels=self.channels).validate()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(**extra) -> dict:
    """Environment of a producer or consumer child: CPU only, so this
    process stays the one that uses the card."""
    return dict(os.environ, JAX_PLATFORMS="cpu", **extra)


def _cli(*args) -> list:
    return [sys.executable, "-m", "wrp_tpu.cli", *map(str, args)]


def _stop(procs, logs=()) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for f in logs:
        f.close()


def _rel(a, b) -> float:
    from wrp_tpu.oracle import relative_l2

    return relative_l2(a, b)


def phase_device() -> dict:
    """JAX's default device must be a GPU (NoGPUError otherwise)."""
    from wrp_tpu.device import card_name_power, require_gpu

    rec = require_gpu()
    card = card_name_power()
    return {"phase": "device", "ok": card is not None, "device": rec,
            "card": card}


def phase_parity(cfg, batch: int, seed: int = 7) -> dict:
    """Every formulation vs the fp64 oracle at cfg's geometry, the
    on-device decode vs the host decode, and the flagship step's memory
    analysis at `batch`."""
    import jax
    import numpy as np

    from wrp_tpu import oracle
    from wrp_tpu.io import codec
    from wrp_tpu.parity import LIMITS, route_parity
    from wrp_tpu.pipeline import DEFAULT_METHOD, METHODS, SectorProcessor

    dev = jax.devices()[0]
    routes = {m: route_parity(SectorProcessor(cfg, method=m, device=dev),
                              cfg, dev) for m in METHODS}

    proc = SectorProcessor(cfg, device=dev)
    wire_proc = SectorProcessor(cfg, device=dev, wire_input=True)
    wires = [codec.encode_iq(oracle.produce_sector_iq(cfg, seed, k), cfg)
             for k in range(2)]
    host = np.stack([codec.decode_iq_i16(w, cfg) for w in wires])
    zdb_h, zdr_h = proc(jax.device_put(host, dev))
    zdb_w, zdr_w = wire_proc(jax.device_put(
        np.stack([np.frombuffer(w, np.uint8) for w in wires]), dev))
    decode_err = max(_rel(zdb_h, zdb_w), _rel(zdr_h, zdr_w))

    mem = proc.lower(batch).compile().memory_analysis()
    memory = {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}
    return {"phase": "parity",
            "ok": all(r["ok"] for r in routes.values())
            and decode_err <= 1e-6,
            "geometry": f"{cfg.num_channels}x{cfg.m}x{cfg.n}",
            "flagship": DEFAULT_METHOD, "limits": LIMITS, "routes": routes,
            "device_decode_vs_host_rel_l2": decode_err,
            "memory_analysis": {"batch": batch, **memory}}


def _produce(sc: SmokeConfig, sectors: int, seed: int, port: int) -> list:
    """argv of a producer at one radar's rate: sector k carries label
    (k mod 143, k div 143) and the IQ of pool entry (seed, k mod pool),
    pre-encoded so the wire keeps the rate (synthesis is ~50 ms/sector)."""
    return _cli("produce", "--transport", "udp", "--sectors", sectors,
                "--headers", "--per-sector-seed", "--seed", seed,
                "--pool", sc.pool, "--rate", sc.rate, "--ingest-port", port,
                "--channels", sc.channels)


def _check_volume(cfg, vol, seed: int, sectors: int, samples: int,
                  pool: int) -> dict:
    """Sampled labels of a volume against the oracle recomputed from
    (seed, k mod pool) — see _produce."""
    import numpy as np

    from wrp_tpu import oracle
    from wrp_tpu.parity import LIMITS

    ks = np.unique(np.linspace(0, sectors - 1, samples).astype(int))
    zdb_err = zdr_err = 0.0
    for k in ks:
        s = k % cfg.num_sectors
        e = (k // cfg.num_sectors) % cfg.num_elevations
        zdb64, zdr64 = oracle.process_sector(
            oracle.produce_sector_iq(cfg, seed, int(k) % pool), cfg)
        zdb_err = max(zdb_err, _rel(zdb64, vol.data[0, :, s, e]))
        zdr_err = max(zdr_err, _rel(zdr64, vol.data[1, :, s, e]))
    return {"oracle_samples": len(ks), "oracle_zdb_rel_l2": zdb_err,
            "oracle_zdr_rel_l2": zdr_err,
            "oracle_ok": bool(zdb_err < LIMITS["zdb"]
                              and zdr_err < LIMITS["zdr"])}


def phase_stream(sc: SmokeConfig, sectors: int,
                 device_decode: bool = False) -> dict:
    """`cli stream` in this process, `cli produce` and `cli consume` as
    CPU children; zero drops, matching volumes, oracle-checked samples."""
    import numpy as np

    from wrp_tpu import cli
    from wrp_tpu.io import codec
    from wrp_tpu.runtime import VolumeScan

    cfg = sc.radar()
    work = Path(tempfile.mkdtemp(prefix="stream-", dir=sc.workdir))
    ing, zdb_port, zdr_port = _free_port(), _free_port(), _free_port()
    ready = work / "ready"
    children = []
    logs = [open(work / "produce.err", "wb"), open(work / "consume.err",
                                                   "wb")]
    feeder_err = []
    stop = threading.Event()

    def feed():
        # the producer starts once the stream is compiled and listening
        while not ready.exists():
            if stop.wait(0.1):
                return
        try:
            children.append(subprocess.Popen(
                _produce(sc, sectors, sc.seed, ing), cwd=REPO,
                env=_child_env(), stdout=subprocess.DEVNULL,
                stderr=logs[0]))
        except Exception as e:          # re-raised by the phase below
            feeder_err.append(e)

    children.append(subprocess.Popen(
        _cli("consume", "--count", sectors, "--timeout", 120,
             "--volume", work / "rx.npz", "--port", zdb_port,
             "--zdr-port", zdr_port, "--channels", sc.channels),
        cwd=REPO, env=_child_env(), stdout=subprocess.DEVNULL,
        stderr=logs[1]))
    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    argv = ["stream", "--transport", "udp", "--batch", sc.stream_batch,
            "--timeout", 2, "--idle-limit", 15,
            "--checkpoint", work / "proc.npz", "--extended-results",
            "--max-sectors", sectors, "--ready-file", ready,
            "--ingest-port", ing, "--zdb-port", zdb_port,
            "--zdr-port", zdr_port, "--channels", sc.channels]
    if device_decode:
        argv.append("--device-decode")
    out = io.StringIO()
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main([str(a) for a in argv])
        stop.set()
        feeder.join()
        if feeder_err:
            raise feeder_err[0]
        rcs = [p.wait(timeout=sc.timeout_s) for p in children]
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        stop.set()
        feeder.join(timeout=30)
        _stop(children, logs)
    stats = json.loads(out.getvalue())
    tr = stats["transport"]
    drops = tr.get("dropped_sectors", 0) + tr.get("dropped_datagrams", 0)
    proc_vol = VolumeScan.load(work / "proc.npz", cfg)
    rx_vol = VolumeScan.load(work / "rx.npz", cfg)
    cov = proc_vol.coverage
    match = bool((cov == rx_vol.coverage).all() and np.array_equal(
        proc_vol.data[:, :, cov], rx_vol.data[:, :, cov], equal_nan=True))
    rec = {"phase": "decode" if device_decode else "stream",
           "sectors": sectors, "rc": [rc, *rcs],
           "processed_sectors": stats["processed_sectors"], "drops": drops,
           "covered_sectors": int(cov.sum()), "volume_match": match,
           "host_decoder": "device" if device_decode
           else codec.decoder_name(),
           "sectors_per_second": stats["sectors_per_second"],
           "latency_ms": stats["latency_ms"],
           **_check_volume(cfg, proc_vol, sc.seed, sectors, sc.samples,
                           sc.pool)}
    rec["ok"] = bool(rc == 0 and not any(rcs) and drops == 0
                     and stats["processed_sectors"] == sectors
                     and rec["covered_sectors"] == min(
                         sectors, cfg.sectors_per_volume)
                     and match and rec["oracle_ok"])
    return rec


def phase_lockstep(sc: SmokeConfig, hosts: int, cards: int) -> dict:
    """`hosts` lock-step `cli stream --num-hosts` processes, each fed its
    own radar; with cards > 0 each sees only its own card.  Checked
    against the oracle and against the single-card route on the same
    sectors (computed here once the fleet has exited)."""
    import jax
    import numpy as np

    from wrp_tpu import oracle
    from wrp_tpu.device import card_env
    from wrp_tpu.parity import LIMITS
    from wrp_tpu.pipeline import SectorProcessor, to_planar
    from wrp_tpu.runtime import VolumeScan

    cfg = sc.radar()
    n = sc.lockstep_sectors
    work = Path(tempfile.mkdtemp(prefix="lockstep-", dir=sc.workdir))
    coordinator = f"localhost:{_free_port()}"
    ports = [_free_port() for _ in range(hosts)]
    streams, producers, logs = [], [], []

    def log(name):
        logs.append(open(work / name, "wb"))
        return logs[-1]

    try:
        for h in range(hosts):
            env = card_env(dict(os.environ), h, cards)
            streams.append(subprocess.Popen(
                _cli("stream", "--transport", "udp", "--coordinator",
                     coordinator, "--num-hosts", hosts, "--host-id", h,
                     "--ingest-port", ports[h], "--zdb-port", _free_port(),
                     "--zdr-port", _free_port(), "--batch",
                     sc.lockstep_batch, "--max-sectors", n,
                     "--timeout", 2, "--idle-limit", 15,
                     "--collective-timeout", 120,
                     "--checkpoint", work / f"h{h}.npz",
                     "--ready-file", work / f"ready{h}",
                     "--channels", sc.channels),
                cwd=REPO, env=env, stdout=log(f"h{h}.out"),
                stderr=log(f"h{h}.err")))
        deadline = time.monotonic() + sc.timeout_s
        while not all((work / f"ready{h}").exists() for h in range(hosts)):
            dead = [s.poll() for s in streams if s.poll() is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(
                    f"lock-step fleet not ready (exit codes {dead}); logs "
                    f"in {work}")
            time.sleep(0.2)
        for h in range(hosts):
            producers.append(subprocess.Popen(
                _produce(sc, n, sc.seed + h, ports[h]), cwd=REPO,
                env=_child_env(), stdout=subprocess.DEVNULL,
                stderr=log(f"produce{h}.err")))
        rcs = [p.wait(timeout=sc.timeout_s) for p in streams + producers]
    finally:
        _stop(streams + producers, logs)

    # the single-card route on the same sectors, in this process now
    # that the fleet has released the cards
    dev = jax.devices()[0]
    proc = SectorProcessor(cfg, device=dev)
    vs_single = vs_oracle = 0.0
    covered = []
    for h in range(hosts):
        vol = VolumeScan.load(work / f"h{h}.npz", cfg)
        covered.append(int(vol.coverage.sum()))
        for k in (0, n - 1):
            s, e = k % cfg.num_sectors, (k // cfg.num_sectors) % \
                cfg.num_elevations
            iq = oracle.produce_sector_iq(cfg, sc.seed + h, k % sc.pool)
            zdb1 = np.asarray(proc(jax.device_put(
                to_planar(iq)[None], dev))[0])[0]
            zdb64, _ = oracle.process_sector(iq, cfg)
            vs_single = max(vs_single, _rel(zdb1, vol.data[0, :, s, e]))
            vs_oracle = max(vs_oracle, _rel(zdb64, vol.data[0, :, s, e]))
    return {"phase": "lockstep", "hosts": hosts, "rc": rcs,
            "covered_sectors": covered,
            "zdb_vs_single_card_rel_l2": vs_single,
            "zdb_vs_oracle_rel_l2": vs_oracle,
            "ok": bool(not any(rcs) and covered == [n] * hosts
                       and vs_single < LIMITS["zdb"]
                       and vs_oracle < LIMITS["zdb"])}


def phase_mesh(cfg, batch: int, seed: int = 7) -> dict:
    """The data-parallel step on a 4x1 mesh and the pulse-shard step on a
    1x4 mesh (planar and wire input), each against the single-card
    route on the same sectors."""
    import jax
    import numpy as np

    from wrp_tpu import oracle
    from wrp_tpu.io import codec
    from wrp_tpu.parallel.mesh import make_mesh
    from wrp_tpu.parallel.sharded import build_sharded_processor
    from wrp_tpu.parity import LIMITS
    from wrp_tpu.pipeline import SectorProcessor

    devs = jax.devices()
    wires = [codec.encode_iq(oracle.produce_sector_iq(cfg, seed, k), cfg)
             for k in range(batch)]
    planar = np.stack([codec.decode_iq_i16(w, cfg) for w in wires])
    wire3 = np.stack([np.frombuffer(w, np.uint8) for w in wires]).reshape(
        batch, cfg.m, -1)
    want = SectorProcessor(cfg, device=devs[0])(
        jax.device_put(planar, devs[0]))
    want = [np.asarray(x) for x in want]

    def compare(step, sharding, x):
        got = step(jax.device_put(x, sharding))
        return {"zdb_rel_l2": _rel(want[0], np.asarray(got[0])),
                "zdr_rel_l2": _rel(want[1], np.asarray(got[1]))}

    out = {}
    for name, (data, seq, wire) in {
            "data_parallel_4x1": (4, 1, False),
            "pulse_shard_1x4": (1, 4, False),
            "pulse_shard_1x4_wire": (1, 4, True)}.items():
        mesh = make_mesh(data=data, seq=seq, devices=devs[:4])
        step, sharding = build_sharded_processor(cfg, mesh, wire_input=wire)
        out[name] = compare(step, sharding, wire3 if wire else planar)
    ok = all(r["zdb_rel_l2"] < LIMITS["zdb"]
             and r["zdr_rel_l2"] < LIMITS["zdr"] for r in out.values())
    return {"phase": "mesh", "ok": ok, "batch": batch,
            "devices": len(devs), **out}


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    if not rec["ok"]:
        raise SystemExit(f"phase {rec['phase']} failed")
    return rec


def run_one_card(sc: SmokeConfig) -> dict:
    dev = _emit(phase_device())
    _emit(phase_parity(sc.radar(), sc.batch, sc.seed))
    _emit(phase_stream(sc, sc.sectors))
    _emit(phase_stream(sc, sc.decode_sectors, device_decode=True))
    return dev


def run_four_cards(sc: SmokeConfig, cards: int) -> dict:
    # the fleet first: its four processes need the cards before this
    # process opens any
    _emit(phase_lockstep(sc, hosts=4, cards=cards))
    dev = _emit(phase_device())
    if dev["device"]["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, JAX sees "
                         f"{dev['device']['count']}")
    _emit(phase_mesh(sc.radar(), sc.mesh_batch, sc.seed))
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phases (lockstep, mesh)")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    try:
        import wrp_tpu
    except ImportError as e:
        print(f"chip_smoke.py needs the wrp_tpu package beside it: {e}",
              file=sys.stderr)
        return 2
    if Path(wrp_tpu.__file__).resolve().parent.parent != REPO:
        print("chip_smoke.py needs the wrp_tpu package beside it, found "
              f"{wrp_tpu.__file__}", file=sys.stderr)
        return 2
    from wrp_tpu.device import NoGPUError, enable_compile_cache, \
        visible_cards

    enable_compile_cache()
    with tempfile.TemporaryDirectory(prefix="wrp-smoke-") as tmp:
        sc = SmokeConfig(workdir=Path(tmp))
        try:
            if args.four_cards:
                cards = visible_cards()
                if cards < 4:
                    print(f"--four-cards needs 4 cards, found {cards}",
                          file=sys.stderr)
                    return 3
                dev = run_four_cards(sc, cards)
            else:
                dev = run_one_card(sc)
        except NoGPUError as e:         # no result, non-zero exit
            print(f"chip_smoke.py: {e}", file=sys.stderr)
            return 3
    print(dev["card"])
    print(json.dumps({"ok": True, "device": dev["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
