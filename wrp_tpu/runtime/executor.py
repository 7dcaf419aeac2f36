"""Streaming executor: the equivalent of the reference's v1
stream-cascade pipeline (gpu_1fp_streamcasc.cu:485-737).

The reference's software pipeline overlapped, per sector: host UDP ingest of
sector k+1, GPU compute of sector k on a round-robin CUDA stream, and D2H of
sector k-1's 4 KB result.  Here the same overlap falls out of a two-thread
design plus a two-deep batch pipeline riding JAX's async dispatch:

  ingest thread:  transport recv -> native/numpy decode -> planar queue
  compute thread: drain batch k+1 -> enqueue its H2D (jax.device_put,
                  async) + dispatch the jit chain (async) -> only then
                  fetch batch k's products -> egress + volume accumulation

While the device runs batch k, the ingest thread is already decoding batch
k+2 and the compute thread is staging batch k+1's transfer — the reference's
proven bottlenecks (SURVEY.md section 6 shows host input dominated every GPU
variant; its fix was async H2D on the next stream,
gpu_1fp_streamcasc.cu:680-688).  Batching replaces CUDA streams: one
dispatch of [B, C, 2, m, n] keeps the card busier than round-robin
single-sector launches ever could.

Adds what the reference lacked (SURVEY.md section 5): recv timeouts with
drop-and-resync recovery, sector/elevation tracking, volume-scan
checkpointing, per-stage timers, and a debug sync-every-batch mode.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..config import RadarConfig, DEFAULT_CONFIG
from ..pipeline import DEFAULT_METHOD, SectorProcessor
from ..io import codec
from .metrics import LatencyStats, StageTimers, Throughput, log
from .volume import VolumeScan


@dataclasses.dataclass
class SectorTask:
    planar: np.ndarray          # [C, 2, m, n] int16/float32, or wire bytes
    sector: int
    elevation: int
    feed: int = 0               # which ingest transport produced it
    t_recv: float = 0.0         # perf_counter at wire arrival (0 = unknown)


class _StallWatchdog:
    """Surfaces a lock-step collective blocked on a silent peer.

    A multi-host collective has no timeout: if one host never issues its
    step (its ingest died or went idle past its recv timeout), every
    other host blocks inside XLA with no error and no log line — the run
    just looks hung.  This side-thread logs a clear diagnostic every
    `interval` seconds for as long as the wrapped section blocks, and —
    when `timeout_s` is set — invokes `on_timeout(what, waited)` once the
    block exceeds it (the bounded-failure exit: the blocked thread is
    stuck inside XLA and cannot be unblocked host-side, so on_timeout is
    expected to checkpoint and end the process)."""

    def __init__(self, what: str, interval: Optional[float],
                 on_warn: Optional[Callable] = None,
                 timeout_s: Optional[float] = None,
                 on_timeout: Optional[Callable] = None):
        self.what = what
        self.interval = interval
        self.on_warn = on_warn
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _watch(self, t0: float):
        wait = self.interval or self.timeout_s
        if self.timeout_s:
            wait = min(wait, self.timeout_s)
        while not self._done.wait(wait):
            waited = time.monotonic() - t0
            if (self.timeout_s is not None and waited >= self.timeout_s
                    and self.on_timeout is not None):
                self.on_timeout(self.what, waited)
                return  # unreachable when on_timeout exits the process
            log.warning(
                "lock-step %s blocked for %.1fs — a peer host is likely "
                "silent (its ingest idle or dead); this host is stuck in "
                "the collective until the peer steps or the run is killed",
                self.what, waited)
            if self.on_warn is not None:
                self.on_warn()

    def __enter__(self):
        armed = (self.interval is not None and self.interval > 0) or (
            self.timeout_s is not None and self.timeout_s > 0)
        if armed:
            self._thread = threading.Thread(
                target=self._watch, args=(time.monotonic(),), daemon=True,
                name="wrp-stall-watchdog")
            self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._thread is not None:
            self._done.set()
            self._thread.join(timeout=1)
        return False


class StreamingExecutor:
    """Pull sectors from a transport, process in batches, publish products.

    transport: object with `recv_sector() -> (bytes | None, header | None)`
               (UdpIngest/TcpIngest/ZmqIngest) or a bare
               `recv_sector() -> bytes | None`;
               or a LIST of such objects — the multi-feed consolidation
               mode: one chip multiplexes several radar feeds (DESIGN.md
               section 6), each feed with its own ingest thread, implicit
               sector counters, volume, and stats, all batched through one
               compiled chain.  Nothing like it exists in the reference
               (one GPU barely kept up with one feed).
    publish:   callable(sector, elevation, zdb, zdr) or an egress object
               with `.send(...)` — v1 egress takes (sector, zdb, zdr),
               v2 takes (sector, elevation, zdb, zdr); both are detected.
               A list gives each feed its own egress (feeds share sector
               labels, so a merged wire would collide); a single object
               receives every feed's frames.
    volume:    a VolumeScan, or a list with one per feed.
    """

    def __init__(
        self,
        cfg: RadarConfig = DEFAULT_CONFIG,
        transport=None,
        publish: Optional[Callable] = None,
        batch: int = 8,
        method: str = DEFAULT_METHOD,
        queue_depth: int = 4,
        debug_sync: bool = False,
        volume: Optional[VolumeScan] = None,
        max_sectors: Optional[int] = None,
        idle_limit: Optional[int] = None,
        processor: Optional[Callable] = None,
        device_decode: bool = False,
        lockstep: bool = False,
        checkpoint_every_s: Optional[float] = 30.0,
        stall_warning_s: Optional[float] = 10.0,
        collective_timeout_s: Optional[float] = None,
        on_ready: Optional[Callable] = None,
    ):
        """idle_limit: stop after this many consecutive idle receive
        timeouts (None = listen forever, the service default).

        processor: override the compiled batch step (e.g.
        parallel.multihost.MultiHostProcessor.step_local for lock-step
        multi-host streaming); default builds a local SectorProcessor.

        device_decode: ingest threads ship RAW wire bytes and the
        byteswap/deinterleave runs on the device inside the processor's
        jit (ops/device_codec) — trades device time for the host decode
        cores.

        lockstep: wait for FULL batches (except at end-of-stream) so every
        host in a multi-host mesh issues the same number of collective
        steps for the same sector count.

        checkpoint_every_s: when a volume with a checkpoint path is
        attached, save it at most this often (atomic rename, volume.py)
        so a crash mid-volume loses at most this much work; <= 0 saves
        after every batch, None disables periodic saves (exit-time save
        only, the round-1 behaviour).

        stall_warning_s: in lock-step mode, log a diagnostic when a
        collective step blocks longer than this (a peer host is silent —
        its ingest idle or dead — and every other host is stuck inside
        the collective with no error surfacing; None disables).

        collective_timeout_s: in lock-step mode, bound the wait on a dead
        peer: when a collective step blocks (or fails) past this, save
        the volume checkpoint, write the stats summary to stderr, and
        exit the process with code 3.  The blocked thread is inside XLA
        and cannot be unblocked host-side, so a clean process exit is
        the only recovery that preserves the volume; a restarted host
        resumes from the checkpoint (cli stream --checkpoint).  None
        (default) keeps the warn-only watchdog.  The coordinator-led
        regroup on top of this exit-and-resume contract lives in
        runtime/supervisor.py (`cli supervise`): survivors relaunch as
        a smaller mesh with the dead host's feeds folded in
        (jax.distributed cannot shrink a live mesh in-process).

        on_ready: called once the warmup compile is done and the ingest
        thread is listening — the point where it is safe to start a
        producer without overflowing the receive buffer (test harnesses
        gate on this instead of guessing compile time with a sleep)."""
        self.cfg = cfg
        self.transports = (list(transport)
                           if isinstance(transport, (list, tuple))
                           else ([transport] if transport is not None
                                 else []))
        self.transport = self.transports[0] if self.transports else None
        self.publishes = (list(publish)
                          if isinstance(publish, (list, tuple))
                          else [publish] * max(1, len(self.transports)))
        if not self.publishes:       # [] means publish nowhere, like None
            self.publishes = [None] * max(1, len(self.transports))
        if len(self.publishes) != max(1, len(self.transports)):
            raise ValueError("publish list must match the transport list")
        self.publish = self.publishes[0]
        self._pub_v2: dict = {}      # feed -> send() takes elevation?
        self.batch = batch
        self.debug_sync = debug_sync
        self.max_sectors = max_sectors
        self.idle_limit = idle_limit
        self.lockstep = lockstep
        self.stall_warning_s = stall_warning_s
        self.collective_timeout_s = collective_timeout_s
        self.stall_warnings = 0
        self._processed = 0
        self.on_ready = on_ready
        nfeeds = max(1, len(self.transports))
        if isinstance(volume, (list, tuple)):
            self.volumes = list(volume)
            if len(self.volumes) != nfeeds:
                raise ValueError("volume list must match the transport list")
        elif len(self.transports) > 1 and volume is not None:
            # feeds share sector/elevation labels: one volume would be
            # silently cross-contaminated
            raise ValueError("multi-feed mode needs one volume per feed "
                             "(pass a list)")
        else:
            self.volumes = [volume] * nfeeds
        self.volume = self.volumes[0]
        self.checkpoint_every_s = checkpoint_every_s
        self._last_checkpoint = 0.0
        self.checkpoints_written = 0
        self.timers = StageTimers()
        self.throughput = Throughput()
        self.latency = LatencyStats()
        # per-feed reservoirs: consolidation mode multiplexes radars with
        # different wire rates through one chip, and a merged percentile
        # would let a fast feed mask a slow feed's tail (the serving
        # question is per radar: "how stale is THIS sweep on screen")
        self.feed_latencies = [LatencyStats() for _ in range(nfeeds)]
        if device_decode and processor is not None and not getattr(
                getattr(processor, "__self__", processor), "wire_input",
                False):
            # an override must advertise that it takes wire bytes (e.g.
            # a bound PulseShardedProcessor.step_local built with
            # device_decode)
            raise ValueError(
                "device_decode with a processor override requires the "
                "override to take wire bytes (wire_input=True)")
        self._device_decode = device_decode
        self._proc_takes_labels = False
        if processor is not None:
            self.processor = processor
            self._host_i16 = False          # external step: float32
            self._do_device_put = False     # steps own their placement
            self._device = None
            # steps that accept labels get each batch's (sector,
            # elevation) rows — PulseShardedProcessor verifies batch
            # alignment across hosts with them (a dropped wire sector on
            # one host would otherwise silently corrupt every host's
            # products through the cross-host all_to_all)
            import inspect

            try:
                self._proc_takes_labels = "labels" in (
                    inspect.signature(processor).parameters)
            except (TypeError, ValueError):
                self._proc_takes_labels = False
        else:
            # built-in step: the compact int16 feed (the 14-bit samples
            # ARE int16; the chain casts on the device), or raw wire
            # bytes decoded on the device
            self.processor = SectorProcessor(cfg, method=method,
                                             wire_input=device_decode)
            self._host_i16 = True
            self._do_device_put = True
            self._device = self.processor.device
        self._queue: "queue.Queue[Optional[SectorTask]]" = queue.Queue(
            maxsize=queue_depth * batch
        )
        # ping-pong batch staging (see _dispatch_batch): two preallocated
        # [batch, ...] buffers + per-buffer count of previously written
        # rows (so partial batches scrub only stale rows, not the whole
        # pad block)
        self._stage_bufs = None
        self._stage_rows = [0, 0]
        self._stage_idx = 0
        self._stop = threading.Event()
        self._ingest_threads: list[threading.Thread] = []
        self._ingest_error: Optional[BaseException] = None
        self._eof_feeds = 0
        self.bad_headers = 0
        # reference counters (rpv2.cu:46-51, advance() :572-579), per feed
        self._pos = [[0, 0] for _ in range(nfeeds)]
        self._feed_processed = [0] * nfeeds

    # ------------------------------------------------------------------
    # ingest side
    # ------------------------------------------------------------------

    def _advance(self, feed: int = 0):
        pos = self._pos[feed]
        pos[0] = (pos[0] + 1) % self.cfg.num_sectors
        if pos[0] == 0:
            pos[1] = (pos[1] + 1) % self.cfg.num_elevations

    def _ingest_loop(self, feed: int = 0):
        transport = self.transports[feed] if self.transports else None
        received = 0
        idle = 0
        try:
            while not self._stop.is_set():
                if self.max_sectors is not None and received >= self.max_sectors:
                    break
                with self.timers.time("ingest/recv"):
                    try:
                        got = transport.recv_sector()
                    except TimeoutError as e:
                        log.warning("feed %d dropped sector: %s", feed, e)
                        self._advance(feed)
                        continue
                if isinstance(got, tuple):
                    wire, header = got
                else:
                    wire, header = got, None
                if wire is None:
                    idle += 1
                    if self.idle_limit is not None and idle >= self.idle_limit:
                        log.info("idle limit reached (%d timeouts), stopping",
                                 idle)
                        break
                    continue
                idle = 0
                t_recv = time.perf_counter()   # wire arrival: latency t0
                if header is not None:
                    sector, elevation = header.sector, header.elevation
                    if not (0 <= sector < self.cfg.num_sectors
                            and 0 <= elevation < self.cfg.num_elevations):
                        # a corrupt wire header must neither kill the run
                        # (volume indexing / result packing would raise)
                        # nor change this host's sector count (lock-step
                        # multi-host needs identical step sequences):
                        # clamp into range and account for it
                        sector %= self.cfg.num_sectors
                        elevation %= self.cfg.num_elevations
                        self.bad_headers += 1
                        log.warning("bad wire header clamped to (%d, %d)",
                                    sector, elevation)
                    self._pos[feed][:] = [sector, elevation]
                else:
                    sector, elevation = self._pos[feed]
                with self.timers.time("ingest/decode"):
                    if self._device_decode:
                        # ship raw bytes; decode runs on the device inside
                        # the processor's jit (transports hand over a
                        # fresh buffer per sector, so the view is safe)
                        planar = np.frombuffer(wire, np.uint8)
                    elif self._host_i16:
                        planar = codec.decode_iq_i16(wire, self.cfg)
                    else:
                        planar = codec.decode_iq(wire, self.cfg)
                task = SectorTask(planar, sector, elevation, feed,
                                  t_recv=t_recv)
                while not self._stop.is_set():
                    try:
                        self._queue.put(task, timeout=0.2)
                        break
                    except queue.Full:
                        continue  # shutdown must not hang on a full queue
                self._advance(feed)
                received += 1
        except BaseException as e:  # surface into run()
            # Log NOW, not just at run() exit: in multi-feed mode the
            # other feeds keep streaming after this one dies, so a
            # silent store would make a dead feed indistinguishable
            # from clean EOF until the whole service stops.
            log.exception("ingest feed %d died; its stream ends here "
                          "(other feeds continue)", feed)
            self._ingest_error = e
        finally:
            # The EOF sentinel must not be lost: a full queue here usually
            # means the consumer is merely slow (it will drain and make
            # room), so retry until the put lands.  Only a set _stop —
            # run() unwinding, never to read the queue again — makes the
            # sentinel unnecessary.
            while not self._stop.is_set():
                try:
                    self._queue.put(None, timeout=0.2)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------------
    # compute side
    # ------------------------------------------------------------------

    def _drain_batch(self):
        """Collect up to `batch` queued sectors (at least one, else None)."""
        tasks = []
        waited0 = 0.0
        nfeeds = max(1, len(self.transports))
        item = None
        while item is None:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                # Defensive liveness check: if every ingest thread died
                # and the queue stayed empty (their EOF sentinels should
                # prevent this), don't block forever.  The queue.empty()
                # guard matters: tasks (and sentinels) enqueued just
                # before ingest exit must still be drained, not dropped.
                ts = self._ingest_threads
                if (ts and all(not t.is_alive() for t in ts)
                        and self._queue.empty()):
                    return None
                if (self.lockstep
                        and self.collective_timeout_s is not None):
                    # a lock-step host that makes no progress cannot tell
                    # a healthy idle mesh from peers blocked on its next
                    # step; with the opt-in timeout, no-progress-for-S
                    # exits with a checkpoint rather than risk wedging
                    # the mesh (set S above the expected sector gap)
                    waited0 += 0.5
                    if waited0 >= self.collective_timeout_s:
                        self._collective_abort(
                            "batch start (no local traffic; peers may be "
                            "blocked on this host's next step)", waited0)
                continue
            if item is None:            # one feed reached end-of-stream
                self._eof_feeds += 1
                if self._eof_feeds >= nfeeds:
                    return None
        tasks.append(item)
        starved_s = 0.0
        next_starve_warn = self.stall_warning_s or float("inf")
        while len(tasks) < self.batch:
            if self.lockstep:
                # full batches only (identical collective step counts on
                # every host); keep waiting unless ingest is provably done
                try:
                    item = self._queue.get(timeout=0.5)
                    # an arrival proves the wire is alive: the starvation
                    # diagnostic is about CONSECUTIVE idle time, not the
                    # accumulated timeouts of a merely-slow stream
                    starved_s = 0.0
                    next_starve_warn = self.stall_warning_s or float("inf")
                except queue.Empty:
                    ts = self._ingest_threads
                    if (ts and all(not t.is_alive() for t in ts)
                            and self._queue.empty()):
                        break  # ingest gone + sentinels consumed elsewhere
                    starved_s += 0.5
                    if (self.collective_timeout_s is not None
                            and starved_s >= self.collective_timeout_s):
                        # mirror image of the blocked-collective abort:
                        # THIS host's wire died mid-batch, peers are (or
                        # will be) blocked on our next step — bound their
                        # wait by exiting the mesh cleanly too
                        self._collective_abort(
                            "batch fill (local ingest idle; peers blocked "
                            "on this host's next step)", starved_s)
                    if starved_s >= next_starve_warn:
                        # the mirror image of _StallWatchdog: THIS host's
                        # wire went quiet mid-batch, so the peers are (or
                        # soon will be) blocked on our next collective step
                        log.warning(
                            "lock-step batch starving: %d/%d sectors after "
                            "%.1fs of idle ingest — peer hosts are blocked "
                            "on this host's next collective step",
                            len(tasks), self.batch, starved_s)
                        self.stall_warnings += 1
                        next_starve_warn += self.stall_warning_s
                    continue
            else:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
            if item is None:           # one feed reached end-of-stream
                self._eof_feeds += 1
                if self._eof_feeds >= max(1, len(self.transports)):
                    self._queue.put(None)  # re-signal EOF for next round
                    break
                continue               # other feeds still flowing
            tasks.append(item)
        return tasks

    def _dispatch_batch(self, tasks):
        """Stage a batch on device (async H2D) and dispatch the compiled
        chain; returns (tasks, zdb, zdr) with the device arrays still in
        flight.  The analogue of the reference's async H2D on the next
        CUDA stream (gpu_1fp_streamcasc.cu:680-688): jax.device_put returns
        immediately with the transfer enqueued, and the jitted dispatch is
        async too, so the caller can keep draining/staging batch k+1 while
        batch k computes."""
        # Pad to the fixed batch shape: one compiled executable for the
        # whole stream (a mid-stream recompile stalls ingest long enough
        # to overflow the receive buffer).  Staged into PREALLOCATED
        # ping-pong buffers: the old stack+zeros+concatenate allocated
        # and copied the full padded batch (~190 MB at batch 8) on every
        # dispatch, which at the partial-batch sizes a paced wire
        # produces burned most of a core in memcpy (measured: 34 ms per
        # ~1.2-sector batch in the r5 host-path soak — the dispatch
        # itself, not the device, was the ceiling).  Two buffers suffice
        # for the two-deep pipeline: buffer A is reused at dispatch k+2,
        # by which point batch k (the previous user of A) has been
        # fetched — its transfer and compute are complete, so nothing
        # reads A anymore even where device_put aliases host memory.
        first = tasks[0].planar
        shape = (self.batch, *first.shape)
        if (self._stage_bufs is None
                or self._stage_bufs[0].shape != shape
                or self._stage_bufs[0].dtype != first.dtype):
            self._stage_bufs = [np.zeros(shape, first.dtype),
                                np.zeros(shape, first.dtype)]
            self._stage_rows = [0, 0]
        idx = self._stage_idx
        self._stage_idx = 1 - idx
        planar = self._stage_bufs[idx]
        for i, t in enumerate(tasks):
            planar[i] = t.planar
        if self._stage_rows[idx] > len(tasks):
            # scrub rows a previous, larger batch wrote (pad rows stay
            # deterministic zeros; their products are discarded anyway)
            planar[len(tasks):self._stage_rows[idx]] = 0
        self._stage_rows[idx] = len(tasks)
        if self._do_device_put:
            import jax

            with self.timers.time("compute/h2d_enqueue"):
                planar = jax.device_put(planar, self._device)
        t_dispatch = time.perf_counter()
        with self.timers.time("compute/dispatch"), \
                self._stall_watch("collective dispatch"):
            try:
                if self._proc_takes_labels:
                    labels = np.full((self.batch, 2), -1, np.int32)
                    for i, t in enumerate(tasks):
                        labels[i] = (t.sector, t.elevation)
                    zdb, zdr = self.processor(planar, labels=labels)
                else:
                    zdb, zdr = self.processor(planar)
            except Exception:
                # a dead peer may surface as a backend error (connection
                # reset) instead of an infinite block — same bounded exit.
                # The full traceback is logged first: the error may just
                # as well be LOCAL (OOM, shape bug), and an operator
                # restarting per the dead-peer guidance needs to see it.
                if self.lockstep and self.collective_timeout_s is not None:
                    log.exception(
                        "collective dispatch raised (may be a dead peer "
                        "OR a local error — see traceback)")
                    self._collective_abort("dispatch (exception)", 0.0)
                raise
        return tasks, zdb, zdr, t_dispatch

    def _complete_batch(self, pending) -> int:
        """Fetch a dispatched batch's products (D2H, blocks until compute
        finishes) and run the host-side epilogue: volume store, egress,
        throughput, periodic checkpoint."""
        tasks, zdb, zdr, t_dispatch = pending
        with self.timers.time("compute/fetch"), \
                self._stall_watch("result fetch"):
            try:
                zdb = np.asarray(zdb)[: len(tasks)]
                zdr = np.asarray(zdr)[: len(tasks)]
            except Exception:
                if self.lockstep and self.collective_timeout_s is not None:
                    log.exception(
                        "collective result fetch raised (may be a dead "
                        "peer OR a local error — see traceback)")
                    self._collective_abort("result fetch (exception)", 0.0)
                raise
        # the device in-flight window: H2D enqueue + dispatch through the
        # blocking fetch — the span everything host-side should overlap
        self.timers.add_interval("compute/in_flight", t_dispatch,
                                 time.perf_counter())
        if self.debug_sync:
            # rpv2's gpuErrchk-after-every-launch as a flag, not a hardcode
            # (rpv2.cu:422-490): validate numerics every batch.
            bad = ~np.isfinite(zdb[:, 1:])
            if bad.any():
                log.error("debug_sync: %d non-finite zdb bins", int(bad.sum()))
        for k, t in enumerate(tasks):
            vol = self.volumes[t.feed]
            if vol is not None:
                vol.store(t.sector, t.elevation, zdb[k], zdr[k])
            if self.publishes[t.feed] is not None:
                with self.timers.time("egress/send"):
                    self._publish_one(t, zdb[k], zdr[k])
            self._feed_processed[t.feed] += 1
            if t.t_recv:
                dt = time.perf_counter() - t.t_recv
                self.latency.record(dt)
                self.feed_latencies[t.feed].record(dt)
        self.throughput.tick(len(tasks))
        self._processed += len(tasks)
        self._maybe_checkpoint()
        return len(tasks)

    def _process_batch(self, tasks):
        """Synchronous dispatch + complete (debug_sync / tests)."""
        return self._complete_batch(self._dispatch_batch(tasks))

    def _stall_watch(self, what: str) -> "_StallWatchdog":
        """Watchdog armed only in lock-step mode: single-host dispatch
        can't block on a peer."""
        interval = self.stall_warning_s if self.lockstep else None
        timeout = self.collective_timeout_s if self.lockstep else None

        def _count():
            self.stall_warnings += 1

        return _StallWatchdog(what, interval, on_warn=_count,
                              timeout_s=timeout,
                              on_timeout=self._collective_abort)

    def _collective_abort(self, what: str, waited: float):
        """Bounded-failure exit (collective_timeout_s): save the volume
        checkpoint, write the stats summary to stderr, exit code 3.

        Runs on the watchdog thread while the main thread is
        irrecoverably blocked inside the XLA collective (nothing
        host-side can unblock it), so it must end the process itself —
        os._exit, since finally/atexit would need the blocked thread.
        The volume is safe to save here: it is only mutated in the
        epilogue of a COMPLETED batch, and the main thread is stuck
        before that point."""
        import json
        import os
        import sys

        log.error(
            "lock-step %s blocked/failed for %.1fs (collective timeout "
            "%.1fs): a peer host is gone; saving the volume checkpoint "
            "and exiting 3 — restart every host with --checkpoint to "
            "resume this volume", what, waited,
            self.collective_timeout_s or 0.0)
        try:
            for vol in self.volumes:
                if vol is not None and vol.path is not None:
                    vol.save()
                    self.checkpoints_written += 1
                    log.info("volume checkpoint saved to %s (%.1f%% "
                             "covered)", vol.path, 100 * vol.fraction())
        except Exception as e:   # a bad disk must not block the exit
            log.error("checkpoint save failed during abort: %s", e)
        try:
            sys.stderr.write(json.dumps(self.stats(self._processed)) + "\n")
            sys.stderr.flush()
        except Exception:
            pass
        os._exit(3)

    def _maybe_checkpoint(self):
        """Periodic crash-safe volume save (VolumeScan.save is an atomic
        write-temp + rename, so a kill mid-save never corrupts the file)."""
        vols = [v for v in self.volumes
                if v is not None and v.path is not None]
        if not vols or self.checkpoint_every_s is None:
            return
        now = time.monotonic()
        if now - self._last_checkpoint >= self.checkpoint_every_s:
            with self.timers.time("checkpoint/save"):
                for v in vols:
                    v.save()
            self._last_checkpoint = now
            self.checkpoints_written += 1

    def _publish_one(self, t: SectorTask, zdb, zdr):
        pub = self.publishes[t.feed]
        if callable(pub) and not hasattr(pub, "send"):
            pub(t.sector, t.elevation, zdb, zdr)
            return
        v2 = self._pub_v2.get(t.feed)
        if v2 is None:
            # Detect the egress arity ONCE by signature (v2 egress takes
            # (sector, elevation, zdb, zdr); v1 takes (sector, zdb,
            # zdr)).  A call-and-catch-TypeError probe would misread a
            # genuine TypeError raised INSIDE a v2 send as a signature
            # mismatch and re-invoke it with the v1 binding (the zdb
            # array landing in the elevation slot) — and would pay a
            # raised exception per sector on every v1 egress.
            import inspect

            try:
                v2 = len(inspect.signature(pub.send).parameters) >= 4
                self._pub_v2[t.feed] = v2
            except (TypeError, ValueError):   # unintrospectable send:
                try:                          # probe ONCE by call
                    pub.send(t.sector, t.elevation, zdb, zdr)
                    self._pub_v2[t.feed] = True
                except TypeError:
                    pub.send(t.sector, zdb, zdr)
                    self._pub_v2[t.feed] = False
                return
        if v2:
            pub.send(t.sector, t.elevation, zdb, zdr)   # v2 signature
        else:
            pub.send(t.sector, zdb, zdr)                # v1 signature

    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Compile the chain before ingest starts (the reference built all
        cuFFT plans up front, rpv2.cu:312-341; a first-batch compile stall
        here would overflow the UDP receive buffer and drop sectors)."""
        c, m, n = self.cfg.sector_shape
        if self._device_decode:
            zeros = np.zeros((self.batch, self.cfg.sector_nbytes_wire),
                             np.uint8)
        else:
            dtype = np.int16 if self._host_i16 else np.float32
            zeros = np.zeros((self.batch, c, 2, m, n), dtype)
        np.asarray(self.processor(zeros)[0])

    def run(self) -> dict:
        """Blocking steady-state loop; returns a stats summary."""
        with self.timers.time("compute/warmup_compile"):
            self.warmup()
        log.info("warmup complete, ingest starting (%d feed%s)",
                 max(1, len(self.transports)),
                 "s" if len(self.transports) > 1 else "")
        self._ingest_threads = [
            threading.Thread(target=self._ingest_loop, args=(k,),
                             daemon=True, name=f"wrp-ingest-{k}")
            for k in range(max(1, len(self.transports)))
        ]
        for t in self._ingest_threads:
            t.start()
        if self.on_ready is not None:
            self.on_ready()
        processed = 0
        next_progress = 100
        # Two-deep software pipeline (the reference's stream cascade,
        # gpu_1fp_streamcasc.cu:527-737, minus the CUDA streams): while
        # batch k computes on device, batch k+1 is drained from the ingest
        # queue, stacked, and its H2D enqueued; only then is batch k's
        # D2H fetch issued.  debug_sync degrades to fully synchronous
        # batches (rpv2's sync-everything mode).
        pending = None

        def complete_pending(replace=None):
            # Swap `pending` out BEFORE completing it: an interrupt
            # (Ctrl-C / SIGTERM) landing mid-completion must neither let
            # the except handler publish the same batch twice
            # (at-most-once egress) nor orphan a just-dispatched batch —
            # `replace` installs the successor in the same statement, so
            # the interrupt window where it is owned by neither variable
            # is a single bytecode, not the whole D2H fetch.
            nonlocal pending, processed
            p, pending = pending, replace
            if p is not None:
                processed += self._complete_batch(p)

        try:
            while True:
                can_fill = (self._queue.qsize() >= self.batch
                            if self.lockstep else not self._queue.empty())
                if pending is not None and not can_fill:
                    # ingest can't progress a batch right now: don't sit
                    # on finished results while (possibly) waiting — the
                    # fetch is the only remaining step; compute is already
                    # in flight.  Publish latency stays bounded even when
                    # the producer pauses mid-stream, including lockstep
                    # mode's full-batch wait.  (Non-lockstep keeps the
                    # empty() test: a partially filled queue still yields
                    # a batch immediately, and eagerly fetching here would
                    # serialise the fetch in front of the next dispatch.)
                    complete_pending()
                tasks = self._drain_batch()
                if tasks is None:
                    break
                nxt = self._dispatch_batch(tasks)
                complete_pending(replace=nxt)
                if self.debug_sync:
                    complete_pending()
                if processed >= next_progress:
                    # the reference's sector-id progress prints
                    # (gpu_1fp_streamcasc.cu:658), rate-limited; the
                    # rolling-window rate excludes the warmup compile
                    log.info("processed %d sectors (%.1f/s)", processed,
                             self.throughput.rate())
                    while processed >= next_progress:
                        next_progress += 100
            if pending is not None:
                complete_pending()
        except KeyboardInterrupt:
            log.info("interrupted after %d sectors, shutting down",
                     processed)
            if pending is not None:
                complete_pending()
        finally:
            self._stop.set()
            for t in self._ingest_threads:
                t.join(timeout=5)
        if self._ingest_error is not None:
            raise self._ingest_error
        return self.stats(processed)

    def stop(self):
        self._stop.set()

    def stats(self, processed: int) -> dict:
        out = {
            "processed_sectors": processed,
            "bad_headers": self.bad_headers,
            "stall_warnings": self.stall_warnings,
            "checkpoints_written": self.checkpoints_written,
            "sectors_per_second": round(self.throughput.overall(), 2),
            "latency_ms": self.latency.summary(),
            "timers": self.timers.summary(),
            "transport": dataclasses.asdict(self.transport.stats)
            if hasattr(self.transport, "stats") else {},
        }
        if len(self.transports) > 1:
            out["feeds"] = [
                {"processed_sectors": self._feed_processed[k],
                 "latency_ms": self.feed_latencies[k].summary(),
                 "transport": dataclasses.asdict(tr.stats)
                 if hasattr(tr, "stats") else {}}
                for k, tr in enumerate(self.transports)
            ]
        return out
