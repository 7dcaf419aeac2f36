"""Coordinator-led mesh regroup for lock-step multi-host streaming.

The reference has no failure story at all: a died process loses the
volume (`rpv2.cu` keeps `result[2,512,143,9]` purely in memory and the
UDP loop never detects a dead peer).  Rounds 2-3 added the survivable
pieces — per-feed volume checkpoints, `--collective-timeout` bounded
exits, SIGTERM-graceful drain, `--checkpoint` resume — but restarting
after a host death was still an operator action.  This module closes
the loop: a supervisor OWNS the feed->host assignment, watches its
worker processes, and on a death *regroups* — it stops the survivors
gracefully (they checkpoint), reassigns the dead host's feeds to the
survivors (the executor's multi-feed consolidation mode), and relaunches
the remaining hosts as a SMALLER lock-step mesh resuming from the
per-feed checkpoints.  Feeds keep their checkpoint files across
generations, so no processed sector is ever re-lost.

Scope: process-level supervision on one box (the same harness the
multi-host tests use).  On a real pod the only thing that changes is
the injected launcher: `spawn(host_id, argv, env, log_file) -> handle`
(see Supervisor.__init__) starts the worker wherever host_id maps —
the generation/regroup state machine is identical, and the supervisor
touches workers ONLY through the returned handle's Popen-shaped
surface (poll/wait/send_signal/kill/pid).  The seam is exercised with
a fake remote fleet — launch latency, machine loss, regroup placement
on survivors — in tests/test_supervisor.py (test_remote_launcher_*).
Sectors broadcast while a feed has no live worker are gone (a radar
cannot replay the sky); that loss window is bounded by the regroup
time and reported per feed.

jax.distributed cannot shrink a live mesh in place (the device set is
fixed at initialize time), so regroup = checkpoint + relaunch with
`num_processes = survivors` — the coordinator-led equivalent of the
"mesh regroup" future step named in round 2's review.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from ..device import card_env
from ..pipeline import DEFAULT_METHOD

log = logging.getLogger("wrp_tpu.supervisor")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@dataclasses.dataclass(frozen=True)
class FeedSpec:
    """One radar feed plus the checkpoint that FOLLOWS the feed across
    regroups (never keyed by host).  udp/tcp feeds are ingest ports the
    worker binds; zmq feeds are endpoints the worker's SUB connects to
    (set `endpoint`, leave `port` None)."""

    port: Optional[int]
    checkpoint: Path
    endpoint: Optional[str] = None

    @property
    def feed_id(self):
        """Stable identity for events/coverage keys."""
        return self.port if self.port is not None else self.endpoint


@dataclasses.dataclass
class _Worker:
    host_id: int
    feeds: List[FeedSpec]
    proc: subprocess.Popen
    ready_file: Path
    log_file: Optional[Path]


class Supervisor:
    """Launch/monitor/regroup a generation-based lock-step fleet.

    Each *generation* is `hosts` worker processes running
    `wrp_tpu.cli stream` with a round-robin share of the feeds; with
    more than one host they join a fresh jax.distributed mesh
    (`--coordinator`, `--num-hosts`, `--host-id`).  The supervisor
    polls worker liveness and per-feed checkpoint coverage:

    * a worker dying (nonzero rc / signal) AFTER its generation became
      ready triggers a REGROUP: SIGTERM the survivors (graceful drain +
      checkpoint), then launch generation g+1 with one fewer host and
      the dead host's feeds folded into the survivors' assignments.
      The supervisor cannot distinguish a transient process failure
      from a lost machine, so post-ready deaths shrink the fleet
      permanently (bounded by `max_generations`);
    * a worker dying DURING warmup (before every ready file appeared)
      is infra flake — no work was accepted yet — so the generation
      relaunches at the SAME host count (fresh coordinator port; this
      also absorbs coordinator-port bind races), still counted against
      `max_generations` so a deterministic crash loop stays bounded;
    * a generation that never becomes ready within `ready_timeout_s`
      without anyone dying ends the run with reason "ready_timeout";
    * with `regrow_after_s` set, a SHRUNK fleet probes back up: once the
      current generation has been ready and healthy that long, the
      supervisor drains it and relaunches with one more host (toward the
      starting count).  A probe generation that dies during warmup means
      the capacity is still gone — fall back to the proven host count
      ("grow_failed") and wait a full window before probing again;
    * every feed reaching `target_sectors` stored sectors ends the run:
      workers get SIGTERM, the supervisor exits 0;
    * all workers exiting 0 on their own (e.g. `--max-sectors`) also
      ends the run.

    SIGTERM/KeyboardInterrupt on the supervisor itself stops the fleet
    gracefully (reason "interrupted") — workers are never orphaned.
    Worker stdout/stderr go to per-generation files under `log_dir`
    (postmortems of host deaths need them); `state_file` is truncated
    at start and events stream to it as JSON lines (launch / ready /
    ready_timeout / warmup_retry / host_death / regroup / grow /
    grow_failed / stopped / done) so harnesses — and the tests — can
    act on supervisor state without scraping logs.
    """

    def __init__(
        self,
        feeds: Sequence[FeedSpec],
        hosts: int,
        *,
        transport: str = "udp",
        batch: int = 8,
        method: str = DEFAULT_METHOD,
        timeout: float = 5.0,
        collective_timeout: float = 30.0,
        target_sectors: Optional[int] = None,
        max_generations: int = 8,
        poll_s: float = 0.5,
        ready_timeout_s: float = 300.0,
        regrow_after_s: Optional[float] = None,
        zdb_port: Optional[int] = None,
        zdr_port: Optional[int] = None,
        result_port: Optional[int] = None,
        state_file: Optional[Path] = None,
        log_dir: Optional[Path] = None,
        extra_args: Sequence[str] = (),
        env: Optional[dict] = None,
        pulse_shard: bool = False,
        cards: int = 0,
        spawn: Optional[Callable[[int, List[str], Optional[dict],
                                  Optional[Path]],
                                 subprocess.Popen]] = None,
    ) -> None:
        """spawn: the launcher seam — `spawn(host_id, argv, env,
        log_file) -> handle`.  Default starts a local subprocess;
        a pod deployment injects one that starts `argv` on the machine
        `host_id` maps to.  The handle must expose the Popen surface
        the supervisor uses: `poll() -> rc|None`, `wait(timeout)`,
        `send_signal(signo)`, `kill()`, `pid`.  host_id is the worker's
        mesh rank within its generation (0..hosts-1) — launchers that
        pin ranks to machines key placement on it.

        pulse_shard: redundant-fleet mode — exactly ONE feed (a
        broadcast wire every host receives: udp broadcast or a zmq PUB
        all SUBs connect to), every host ingests the whole wire, and
        the workers run `stream --pulse-shard` (each computes a 1/N
        pulse slice, full products on every host).  A host death
        shrinks the fleet and the pulse split re-slices automatically;
        each host keeps its own checkpoint of the SAME volume
        (<feed>.hK.npz), the freshest copy seeding every new
        generation, so no processed sector is lost while ANY host
        survives.  A 1-host generation degenerates to a plain stream
        consuming the full wire.

        cards: cards on this machine.  With cards > 0 worker host_id
        runs with CUDA_VISIBLE_DEVICES=host_id, so each process opens
        one card (a JAX process reserves most of every card it opens);
        more hosts than cards is refused."""
        if not feeds:
            raise ValueError("need at least one feed")
        if hosts < 1:
            raise ValueError("need at least one host")
        if pulse_shard:
            if len(feeds) != 1:
                raise ValueError("pulse_shard supervises exactly one "
                                 "broadcast feed (every host receives "
                                 "the whole wire)")
            if transport == "tcp":
                raise ValueError("pulse_shard needs a fan-out wire "
                                 "(udp broadcast or zmq pub/sub); tcp "
                                 "delivers each sector to one reader")
            from ..parallel.sharded import SHARD_METHODS

            if method not in SHARD_METHODS:
                raise ValueError("pulse_shard supports method "
                                 f"{', '.join(SHARD_METHODS)}")
        elif hosts > len(feeds):
            # a host with zero feeds would idle forever and (in lock-step
            # mode) starve the mesh into everyone's collective timeout
            raise ValueError(f"{hosts} hosts but only {len(feeds)} feeds")
        if cards and hosts > cards:
            raise ValueError(f"{hosts} hosts but {cards} cards: one "
                             "process per card")
        self.cards = cards
        self.pulse_shard = pulse_shard
        if transport not in ("udp", "tcp", "zmq"):
            raise ValueError(f"unsupported transport {transport!r}")
        for f in feeds:
            if transport == "zmq" and not f.endpoint:
                raise ValueError("zmq feeds need endpoint=, not port=")
            if transport != "zmq" and f.port is None:
                raise ValueError(f"{transport} feeds need port=")
        self.feeds = list(feeds)
        self.hosts = hosts
        self.transport = transport
        self.batch = batch
        self.method = method
        self.timeout = timeout
        self.collective_timeout = collective_timeout
        self.target_sectors = target_sectors
        self.max_generations = max_generations
        self.poll_s = poll_s
        self.ready_timeout_s = ready_timeout_s
        if regrow_after_s is not None and regrow_after_s <= 0:
            raise ValueError("regrow_after_s must be positive")
        self.regrow_after_s = regrow_after_s
        # the starting count is the capacity ceiling: the supervisor was
        # handed `hosts` slots, so growth probes never exceed it (and the
        # hosts<=feeds ctor guard keeps every grown host fed)
        self._max_hosts = hosts
        if len({f.feed_id for f in self.feeds}) != len(self.feeds):
            raise ValueError("duplicate feed ports")
        if len({f.checkpoint for f in self.feeds}) != len(self.feeds):
            raise ValueError("duplicate feed checkpoints (two volumes "
                             "over one file silently clobber each other)")
        self.zdb_port = zdb_port
        self.zdr_port = zdr_port
        self.result_port = result_port
        self.state_file = Path(state_file) if state_file else None
        if self.state_file:
            # one run per file: a reader matching "generation 0" must
            # never pick up a previous run's events
            self.state_file.parent.mkdir(parents=True, exist_ok=True)
            self.state_file.write_text("")
        self.log_dir = Path(log_dir) if log_dir else None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
        self.extra_args = list(extra_args)
        self.env = dict(env) if env is not None else None
        self._spawn = spawn or self._default_spawn
        self.generation = -1
        # ready-file dir is created lazily in run() so validation-only
        # constructions don't leak temp dirs (cleanup lives in run())
        self._tmp: Optional[Path] = None
        self._events: List[dict] = []
        self._workers: List[_Worker] = []
        # checkpoint read cache: (mtime_ns, size) -> coverage count, so
        # the 0.5 s poll doesn't deserialize every volume every tick
        self._cov_cache: dict = {}

    def _default_spawn(self, host_id: int, argv: List[str],
                       env: Optional[dict],
                       log_file: Optional[Path]) -> subprocess.Popen:
        del host_id               # local launcher: every rank is this box
        if log_file is None:
            return subprocess.Popen(argv, env=env,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
        out = open(log_file, "ab")
        try:
            return subprocess.Popen(argv, env=env, stdout=out, stderr=out)
        finally:
            out.close()      # the child holds its own fd

    # ---------------------------------------------------------- events

    def _event(self, kind: str, **fields) -> None:
        ev = {"event": kind, "generation": self.generation,
              "t": time.time(), **fields}
        self._events.append(ev)
        log.info("supervisor: %s %s", kind, fields)
        if self.state_file:
            # append+flush per event: readers poll this file live
            with open(self.state_file, "a") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())

    # ------------------------------------------------------- lifecycle

    def _assign(self, hosts: int) -> List[List[FeedSpec]]:
        """Round-robin feeds over hosts — the dead host's feeds land on
        survivors without moving anyone else's checkpoint files.
        pulse_shard: every host ingests the one broadcast feed."""
        if self.pulse_shard:
            return [[self.feeds[0]] for _ in range(hosts)]
        shares: List[List[FeedSpec]] = [[] for _ in range(hosts)]
        for i, f in enumerate(self.feeds):
            shares[i % hosts].append(f)
        return shares

    def _host_ckpt(self, host_id: int) -> Path:
        """pulse_shard: host slot K's copy of the shared volume."""
        base = self.feeds[0].checkpoint
        return base.parent / f"{base.stem}.h{host_id}{base.suffix}"

    def _seed_host_ckpts(self, hosts: int) -> None:
        """pulse_shard: every generation starts each slot from the
        FRESHEST surviving copy of the volume — a slot whose host died
        generations ago would otherwise resume a stale file and carry a
        permanent coverage gap."""
        existing = [(p.stat().st_mtime_ns, p)
                    for p in (self._host_ckpt(k)
                              for k in range(self._max_hosts))
                    if p.exists()]
        if not existing:
            return
        freshest = max(existing)[1]
        for k in range(hosts):
            dst = self._host_ckpt(k)
            if dst != freshest:
                try:
                    shutil.copy2(freshest, dst)
                except OSError as e:   # stale slot is better than no run
                    log.warning("could not seed %s from %s: %s",
                                dst, freshest, e)

    def _worker_argv(self, host_id: int, hosts: int, feeds: List[FeedSpec],
                     ready: Path, coordinator: Optional[str]) -> List[str]:
        argv = [
            sys.executable, "-m", "wrp_tpu.cli", "stream",
            "--transport", self.transport,
            "--batch", str(self.batch),
            "--method", self.method,
            "--timeout", str(self.timeout),
            "--checkpoint-every", "0",        # checkpoint every batch:
                                              # regroup loses at most the
                                              # in-flight batch
            "--ready-file", str(ready),
            "--collective-timeout", str(self.collective_timeout),
        ]
        if self.pulse_shard:
            # one broadcast wire, whole-wire ingest per host, per-slot
            # copy of the one volume; the pulse split itself needs the
            # lock-step mesh, so a 1-host generation runs plain
            f = feeds[0]
            if self.transport == "zmq":
                argv += ["--zmq-sub", str(f.endpoint),
                         "--zmq-pub", f"tcp://127.0.0.1:{_free_port()}"]
            else:
                argv += ["--ingest-port", str(f.port)]
            argv += ["--checkpoint", str(self._host_ckpt(host_id))]
            if coordinator is not None:
                argv += ["--pulse-shard"]
        elif self.transport == "zmq":
            for f in feeds:
                argv += ["--feed-endpoint", str(f.endpoint)]
            # ZmqEgress BINDS its pub endpoint: co-hosted workers need
            # distinct ones; the launch event records each worker's as
            # zmq_pub so consumers can subscribe (per-feed checkpoints
            # stay the authoritative volumes either way)
            argv += ["--zmq-pub", f"tcp://127.0.0.1:{_free_port()}"]
        else:
            for f in feeds:
                argv += ["--feed-port", str(f.port)]
        if not self.pulse_shard:
            for f in feeds:
                argv += ["--feed-checkpoint", str(f.checkpoint)]
        if self.zdb_port is not None:
            argv += ["--zdb-port", str(self.zdb_port)]
        if self.zdr_port is not None:
            argv += ["--zdr-port", str(self.zdr_port)]
        if self.result_port is not None:
            argv += ["--result-port", str(self.result_port)]
        if coordinator is not None:
            argv += ["--coordinator", coordinator,
                     "--num-hosts", str(hosts), "--host-id", str(host_id)]
        return argv + self.extra_args

    def _launch_generation(self, hosts: int) -> List[_Worker]:
        self.generation += 1
        if self.pulse_shard:
            self._seed_host_ckpts(hosts)
        shares = self._assign(hosts)
        # >1 host: a fresh lock-step mesh (new coordinator port — the old
        # coordination service died with generation g-1's host 0).
        # 1 host: plain streaming; a 1-process mesh adds only risk.
        coordinator = f"127.0.0.1:{_free_port()}" if hosts > 1 else None
        # self._workers IS the list being filled: a spawn that raises
        # (or an interrupt landing mid-loop) must leave the already-
        # started workers visible to run()'s cleanup, not orphan them
        workers: List[_Worker] = []
        self._workers = workers
        pubs: List[Optional[str]] = []
        for host_id, share in enumerate(shares):
            ready = self._tmp / f"ready-g{self.generation}-h{host_id}"
            logf = (self.log_dir / f"g{self.generation}-h{host_id}.log"
                    if self.log_dir else None)
            argv = self._worker_argv(host_id, hosts, share, ready,
                                     coordinator)
            pubs.append(argv[argv.index("--zmq-pub") + 1]
                        if "--zmq-pub" in argv else None)
            proc = self._spawn(host_id, argv,
                               card_env(self.env, host_id, self.cards), logf)
            workers.append(_Worker(host_id, share, proc, ready, logf))
        self._event("launch", hosts=hosts, coordinator=coordinator,
                    workers=[{"host_id": w.host_id, "pid": w.proc.pid,
                              "feeds": [f.feed_id for f in w.feeds],
                              "zmq_pub": pub,
                              "log": str(w.log_file) if w.log_file
                              else None}
                             for w, pub in zip(workers, pubs)])
        return workers

    def _await_ready(self, workers: List[_Worker]) -> str:
        """-> "ready" | "died" (a worker exited during warmup) |
        "timeout" (nobody died, nobody became ready)."""
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            if all(w.ready_file.exists() for w in workers):
                self._event("ready")
                return "ready"
            if any(w.proc.poll() is not None for w in workers):
                return "died"
            # the target can already be satisfied by pre-existing
            # checkpoints; don't require a ready generation to see it
            if self.target_sectors is not None and all(
                    self._feed_done(f) for f in self.feeds):
                return "ready"
            time.sleep(self.poll_s)
        self._event("ready_timeout")
        return "timeout"

    def _stop(self, workers: List[_Worker], why: str,
              event: bool = True) -> None:
        """Graceful stop: SIGTERM (drain + checkpoint), bounded wait,
        then SIGKILL the exact PIDs that remain.  Emits the "stopped"
        event even when nobody was left alive (harnesses key on it);
        event=False is the final safety pass in run()'s finally, which
        must not write after the "done" event."""
        live = [w for w in workers if w.proc.poll() is None]
        if not live:
            if event and workers:
                self._event("stopped", why=why)
            return
        for w in live:
            try:
                w.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        bound = self.collective_timeout + 15.0
        deadline = time.monotonic() + bound
        for w in live:
            left = max(0.1, deadline - time.monotonic())
            try:
                w.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                w.proc.kill()     # exact PID, never a pattern
                w.proc.wait(timeout=10)
        if event:
            self._event("stopped", why=why)

    # ------------------------------------------------------ completion

    def _feed_coverage(self, feed: FeedSpec) -> int:
        """Stored-sector count, reloaded only when the file changed
        (workers save via atomic rename, so mtime+size is a sound
        staleness key).  pulse_shard: the volume is replicated per host
        slot — the FRESHEST copy is the feed's coverage."""
        if self.pulse_shard:
            return max((self._coverage_of(self._host_ckpt(k))
                        for k in range(self._max_hosts)), default=0)
        return self._coverage_of(feed.checkpoint)

    def _coverage_of(self, path: Path) -> int:
        from .volume import VolumeScan

        try:
            st = os.stat(path)
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            return 0
        cached = self._cov_cache.get(path)
        if cached is not None and cached[0] == key:
            return cached[1]
        try:
            n = int(VolumeScan.load(str(path)).coverage.sum())
        except Exception:
            return 0              # mid-rename
        self._cov_cache[path] = (key, n)
        return n

    def _feed_done(self, feed: FeedSpec) -> bool:
        if self.target_sectors is None:
            return False
        return self._feed_coverage(feed) >= self.target_sectors

    def _coverage(self) -> dict:
        return {str(f.feed_id): self._feed_coverage(f)
                for f in self.feeds}

    # ------------------------------------------------------------- run

    def run(self) -> dict:
        """Supervise until every feed hits the target (exit reason
        "target"), all workers finish on their own ("workers_done"), or
        the run fails ("exhausted" / "max_generations" /
        "ready_timeout" / "interrupted" — nonzero for the CLI).
        Workers are never orphaned: every exit path, including
        SIGTERM/Ctrl-C on the supervisor and exceptions from event
        writing, stops the current generation first."""
        self._tmp = Path(tempfile.mkdtemp(prefix="wrp_supervise_"))
        try:
            return self._run()
        except KeyboardInterrupt:
            # stop the fleet BEFORE reading coverage: the SIGTERMed
            # workers drain and write their final checkpoints, which
            # the "interrupted" summary must include
            self._stop(self._workers, why="interrupted")
            return self._finish(False, "interrupted")
        finally:
            self._stop(self._workers, why="shutdown", event=False)
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def _finish(self, ok: bool, reason: str) -> dict:
        cov = self._coverage()
        self._event("done", reason=reason, coverage=cov)
        return {"ok": ok, "reason": reason,
                "generations": self.generation + 1, "coverage": cov}

    def _run(self) -> dict:
        hosts = self.hosts
        # host count to fall back to when the current GROWTH PROBE
        # generation dies during warmup (the regained capacity was not
        # real); None whenever the current generation is a proven size
        probe_from: Optional[int] = None
        while True:
            workers = self._launch_generation(hosts)
            readiness = self._await_ready(workers)
            if readiness == "timeout":
                # nobody died, nobody came up: relaunching the same
                # thing would hang the same way — fail loudly
                self._stop(workers, why="ready_timeout")
                return self._finish(False, "ready_timeout")
            if readiness == "ready":
                probe_from = None          # the grown fleet is real now
            reason = self._monitor(workers, hosts)
            if reason == "grow":
                # the shrunk fleet has been healthy a full window: drain
                # it (checkpoints follow the feeds) and probe one host up
                self._stop(workers, why="grow")
                probe_from = hosts
                hosts += 1
                self._event("grow", to_hosts=hosts)
                continue
            if reason == "regroup":
                dead = [w for w in workers
                        if w.proc.poll() not in (None, 0)]
                self._stop(workers, why="regroup")
                if self.generation + 1 >= self.max_generations:
                    return self._finish(False, "max_generations")
                if readiness != "ready":
                    if probe_from is not None:
                        # a growth probe that cannot even warm up means
                        # the capacity is still gone: fall back to the
                        # proven count and wait a full window to re-probe
                        hosts = probe_from
                        probe_from = None
                        self._event("grow_failed", back_to_hosts=hosts,
                                    dead=[w.host_id for w in dead])
                        continue
                    # warmup death: no accepted work was lost, so this
                    # is infra flake (coordinator-port race, OOM blip) —
                    # retry at the SAME host count on a fresh port
                    self._event("warmup_retry", hosts=hosts,
                                dead=[w.host_id for w in dead])
                    continue
                hosts -= len(dead)
                if hosts < 1:
                    return self._finish(False, "exhausted")
                self._event("regroup", to_hosts=hosts,
                            dead=[w.host_id for w in dead])
                continue
            self._stop(workers, why=reason)
            return self._finish(True, reason)

    def _monitor(self, workers: List[_Worker], hosts: int) -> str:
        ready_at = time.monotonic()
        while True:
            if self.target_sectors is not None and all(
                    self._feed_done(f) for f in self.feeds):
                return "target"
            rcs = [w.proc.poll() for w in workers]
            if any(rc not in (None, 0) for rc in rcs):
                for w, rc in zip(workers, rcs):
                    if rc not in (None, 0):
                        self._event("host_death", host_id=w.host_id,
                                    rc=rc,
                                    feeds=[f.feed_id for f in w.feeds])
                return "regroup"
            if all(rc == 0 for rc in rcs):
                return "workers_done"
            if (self.regrow_after_s is not None
                    and hosts < self._max_hosts
                    # growing must never end an otherwise healthy run on
                    # the max_generations bound: budget BOTH the probe
                    # generation AND its warmup-death fallback relaunch,
                    # or a failed probe at the last slot would finish the
                    # run with reason max_generations instead of falling
                    # back to the proven fleet
                    and self.generation + 2 < self.max_generations
                    and time.monotonic() - ready_at >= self.regrow_after_s):
                return "grow"
            time.sleep(self.poll_s)
