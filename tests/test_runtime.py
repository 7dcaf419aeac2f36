"""Runtime components: volume checkpointing, metrics, executor batching."""

import numpy as np
import pytest

from wrp_tpu.config import tiny_config
from wrp_tpu.runtime import VolumeScan, StageTimers, Throughput
from wrp_tpu.runtime.executor import StreamingExecutor, SectorTask


def test_volume_store_and_coverage(tmp_path):
    cfg = tiny_config(m=16, n=8)
    vs = VolumeScan(cfg, tmp_path / "vol.npz")
    assert vs.fraction() == 0.0
    zdb = np.arange(cfg.num_output_bins, dtype=np.float32)
    vs.store(3, 1, zdb, -zdb)
    assert vs.coverage[3, 1] and not vs.complete()
    np.testing.assert_array_equal(vs.data[0, :, 3, 1], zdb)
    np.testing.assert_array_equal(vs.data[1, :, 3, 1], -zdb)


def test_volume_checkpoint_resume(tmp_path):
    cfg = tiny_config(m=16, n=8)
    vs = VolumeScan(cfg, tmp_path / "vol.npz")
    for s in range(cfg.num_sectors):
        vs.store(s, 0, np.full(cfg.num_output_bins, float(s), np.float32),
                 np.zeros(cfg.num_output_bins, np.float32))
    p = vs.save()
    resumed = VolumeScan.load(p, cfg)
    assert resumed.fraction() == vs.fraction()
    np.testing.assert_array_equal(resumed.data, vs.data)
    # geometry mismatch rejected
    with pytest.raises(ValueError):
        VolumeScan.load(p, tiny_config(m=32, n=8))


def test_stage_timers():
    t = StageTimers()
    with t.time("a"):
        pass
    with t.time("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
    assert s["a"]["total_s"] >= 0


def test_throughput_counter():
    tp = Throughput()
    tp.tick(5)
    tp.tick(3)
    assert tp.count == 8
    assert tp.rate() > 0


class _FakeTransport:
    """Feeds N wire sectors then EOF, mimicking UdpIngest's tuple API."""

    def __init__(self, cfg, n):
        from wrp_tpu.io import codec

        self.cfg = cfg
        rng = np.random.default_rng(0)
        self.wires = [
            codec.encode_iq(
                rng.integers(-2048, 2048, cfg.sector_shape)
                + 1j * rng.integers(-2048, 2048, cfg.sector_shape), cfg)
            for _ in range(n)
        ]
        self.i = 0

    def recv_sector(self):
        if self.i >= len(self.wires):
            raise TimeoutError("eof")
        w = self.wires[self.i]
        self.i += 1
        return w, None


def test_executor_end_to_end():
    cfg = tiny_config(m=32, n=16)
    n = 10
    transport = _FakeTransport(cfg, n)
    published = []
    vs = VolumeScan(cfg)
    ex = StreamingExecutor(
        cfg, transport=transport,
        publish=lambda s, e, zdb, zdr: published.append((s, e)),
        batch=4, max_sectors=n, volume=vs, debug_sync=True,
    )
    stats = ex.run()
    assert stats["processed_sectors"] == n
    assert len(published) == n
    # sector/elevation counters advanced like rpv2 (wrap at num_sectors)
    assert published[0] == (0, 0)
    assert published[cfg.num_sectors] == (0, 1)  # elevation bump on wrap
    assert vs.coverage.sum() == n
    # per-stage timers recorded
    assert "ingest/decode" in stats["timers"]
    assert "compute/dispatch" in stats["timers"]


def test_executor_periodic_checkpoint_and_crash_resume(tmp_path):
    """Kill-mid-volume scenario (VERDICT round 1, item 3): the executor
    saves periodically, so a run that dies WITHOUT an exit-time save still
    leaves a resumable checkpoint; a restarted executor loads it and fills
    in the rest of the volume."""
    cfg = tiny_config(m=32, n=16)
    path = tmp_path / "vol.npz"
    n1 = 6

    # first run: periodic save after every batch, then "crash" (no
    # exit-time save, the executor object is simply abandoned)
    vs = VolumeScan(cfg, path)
    ex = StreamingExecutor(cfg, transport=_FakeTransport(cfg, n1),
                           batch=2, max_sectors=n1, volume=vs,
                           checkpoint_every_s=0.0)
    stats = ex.run()
    assert stats["checkpoints_written"] >= 1
    assert path.exists()

    # restart: the CLI's resume path loads coverage from the file
    from wrp_tpu.cli import _open_volume

    vs2 = _open_volume(cfg, path)
    assert vs2.coverage.sum() == n1
    np.testing.assert_array_equal(vs2.data, vs.data)

    # second run continues the scan (FakeTransport restarts at sector 0;
    # shift the executor's counters so new sectors land after the first 6)
    n2 = 4
    ex2 = StreamingExecutor(cfg, transport=_FakeTransport(cfg, n2),
                            batch=2, max_sectors=n2, volume=vs2,
                            checkpoint_every_s=0.0)
    ex2._pos[0][:] = [n1 % cfg.num_sectors, n1 // cfg.num_sectors]
    ex2.run()
    vs3 = VolumeScan.load(path, cfg)
    assert vs3.coverage.sum() == n1 + n2


def test_open_volume_fresh_and_geometry_mismatch(tmp_path):
    from wrp_tpu.cli import _open_volume

    cfg = tiny_config(m=16, n=8)
    path = tmp_path / "v.npz"
    vs = _open_volume(cfg, path)          # fresh: no file yet
    assert vs.fraction() == 0.0 and vs.path == path
    vs.store(0, 0, np.zeros(cfg.num_output_bins, np.float32),
             np.zeros(cfg.num_output_bins, np.float32))
    vs.save()
    with pytest.raises(ValueError):       # stale file from another radar
        _open_volume(tiny_config(m=32, n=8), path)


def test_executor_checkpoint_disabled(tmp_path):
    cfg = tiny_config(m=32, n=16)
    path = tmp_path / "vol.npz"
    ex = StreamingExecutor(cfg, transport=_FakeTransport(cfg, 2),
                           batch=2, max_sectors=2,
                           volume=VolumeScan(cfg, path),
                           checkpoint_every_s=None)
    stats = ex.run()
    assert stats["checkpoints_written"] == 0
    assert not path.exists()


def test_two_deep_pipeline_dispatch_then_complete():
    """The executor's H2D/compute overlap (VERDICT round 1, item 4): two
    batches can be in flight before either is fetched, and the results are
    still correct and in order."""
    from wrp_tpu.io import codec
    from wrp_tpu.pipeline import SectorProcessor

    cfg = tiny_config(m=32, n=16)
    transport = _FakeTransport(cfg, 4)
    wires = list(transport.wires)
    got = {}
    ex = StreamingExecutor(
        cfg, transport=transport, batch=2, max_sectors=4,
        publish=lambda s, e, zdb, zdr: got.__setitem__(s, zdb.copy()),
    )
    ex.warmup()
    mk = lambda k: SectorTask(codec.decode_iq(wires[k], cfg), k, 0)
    p1 = ex._dispatch_batch([mk(0), mk(1)])
    p2 = ex._dispatch_batch([mk(2), mk(3)])   # in flight before p1 fetched
    assert ex._complete_batch(p1) == 2
    assert ex._complete_batch(p2) == 2
    assert ex.timers.summary()["compute/h2d_enqueue"]["count"] >= 2
    proc = SectorProcessor(cfg)         # the executor's default route
    for k in range(4):
        zdb, _ = proc(codec.decode_iq(wires[k], cfg)[None])
        np.testing.assert_array_equal(got[k], np.asarray(zdb)[0])


def test_eof_sentinel_survives_full_queue():
    """Regression (round-1 advisor): the ingest thread's EOF sentinel used
    put_nowait and was silently swallowed when the queue was full — the
    consumer then blocked forever.  The sentinel put must retry until the
    (merely slow) consumer makes room."""
    import threading
    import time

    cfg = tiny_config(m=32, n=16)
    ex = StreamingExecutor(cfg, transport=None, batch=1, queue_depth=1,
                           max_sectors=0)
    task = SectorTask(np.zeros((3, 2, cfg.m, cfg.n), np.float32), 0, 0)
    ex._queue.put_nowait(task)          # queue now full (maxsize 1)
    t = threading.Thread(target=ex._ingest_loop, daemon=True)
    ex._ingest_threads = [t]
    t.start()
    time.sleep(0.3)                     # old code lost the sentinel here
    got = ex._drain_batch()
    assert got and got[0] is task
    assert ex._drain_batch() is None    # EOF still signalled
    t.join(timeout=5)
    assert not t.is_alive()


def test_executor_results_match_direct_pipeline():
    from wrp_tpu.io import codec
    from wrp_tpu.pipeline import SectorProcessor

    cfg = tiny_config(m=32, n=16)
    transport = _FakeTransport(cfg, 3)
    wires = list(transport.wires)
    got = {}
    ex = StreamingExecutor(
        cfg, transport=transport,
        publish=lambda s, e, zdb, zdr: got.__setitem__(s, (zdb, zdr)),
        batch=2, max_sectors=3,
    )
    ex.run()
    proc = SectorProcessor(cfg)         # the executor's default route
    for k, wire in enumerate(wires):
        planar = codec.decode_iq_i16(wire, cfg)     # its compact feed
        zdb, zdr = proc(planar[None])
        np.testing.assert_array_equal(got[k][0], np.asarray(zdb)[0])
        np.testing.assert_array_equal(got[k][1], np.asarray(zdr)[0])


def test_lockstep_stall_watchdog_fires():
    """A slow collective step in lock-step mode must surface diagnostics
    (round-1 VERDICT weak item 4: a silent peer looked like a hang)."""
    import time

    cfg = tiny_config(m=16, n=8)

    def slow_processor(planar):
        time.sleep(0.7)  # stands in for a collective blocked on a peer
        b = planar.shape[0]
        k = cfg.num_output_bins
        return np.zeros((b, k), np.float32), np.zeros((b, k), np.float32)

    ex = StreamingExecutor(cfg, batch=2, processor=slow_processor,
                           lockstep=True, stall_warning_s=0.2)
    c, m, n = cfg.sector_shape
    tasks = [SectorTask(np.zeros((c, 2, m, n), np.float32), s, 0)
             for s in range(2)]
    ex._process_batch(tasks)
    assert ex.stall_warnings >= 2
    assert ex.stats(2)["stall_warnings"] == ex.stall_warnings


def test_lockstep_stall_watchdog_quiet_when_fast():
    cfg = tiny_config(m=16, n=8)

    def fast_processor(planar):
        b, k = planar.shape[0], cfg.num_output_bins
        return np.zeros((b, k), np.float32), np.zeros((b, k), np.float32)

    ex = StreamingExecutor(cfg, batch=2, processor=fast_processor,
                           lockstep=True, stall_warning_s=0.5)
    c, m, n = cfg.sector_shape
    tasks = [SectorTask(np.zeros((c, 2, m, n), np.float32), s, 0)
             for s in range(2)]
    ex._process_batch(tasks)
    assert ex.stall_warnings == 0


def test_lockstep_drain_starvation_warns():
    """A half-filled lock-step batch with idle ingest warns that peers are
    blocked on this host's next collective step."""
    import threading

    cfg = tiny_config(m=16, n=8)
    ex = StreamingExecutor(cfg, batch=4, processor=lambda p: (p, p),
                           lockstep=True, stall_warning_s=0.5)
    # a live stand-in ingest thread (drain treats a dead one as EOF)
    alive = threading.Event()
    t = threading.Thread(target=alive.wait, daemon=True)
    t.start()
    ex._ingest_threads = [t]
    c, m, n = cfg.sector_shape
    ex._queue.put(SectorTask(np.zeros((c, 2, m, n), np.float32), 0, 0))
    threading.Timer(1.3, ex._queue.put, args=(None,)).start()
    tasks = ex._drain_batch()
    alive.set()
    assert len(tasks) == 1
    assert ex.stall_warnings >= 1


def test_interrupt_mid_publish_no_double_publish():
    """An interrupt landing inside batch completion must not re-publish
    the batch from the except handler (at-most-once egress)."""
    cfg = tiny_config(m=16, n=8)
    c, m, n = cfg.sector_shape
    published = []
    raised = []

    def publish(sector, elevation, zdb, zdr):
        published.append(sector)
        if sector == 1 and not raised:
            raised.append(True)
            raise KeyboardInterrupt

    class TwoSectorTransport:
        def __init__(self):
            from wrp_tpu.io import codec

            iq = np.zeros(cfg.sector_shape, np.complex128)
            self.wire = codec.encode_iq(iq, cfg)
            self.n = 0

        def recv_sector(self):
            self.n += 1
            if self.n <= 2:
                from wrp_tpu.io import frames

                return self.wire, frames.IngestHeader(self.n - 1, 0, 0)
            return None, None

    ex = StreamingExecutor(cfg, transport=TwoSectorTransport(),
                           publish=publish, batch=2, max_sectors=2,
                           idle_limit=1,
                           processor=lambda p: (
                               np.zeros((p.shape[0], cfg.num_output_bins),
                                        np.float32),
                               np.zeros((p.shape[0], cfg.num_output_bins),
                                        np.float32)))
    ex.run()
    # sector 0 published exactly once; sector 1's publish attempt raised —
    # the old code re-ran the whole batch from the except handler,
    # publishing sector 0 twice
    assert published.count(0) == 1, published


def test_lockstep_starvation_counter_resets_on_arrival():
    """A slow-but-alive wire (items trickling in with sub-threshold gaps)
    must NOT trigger the starvation diagnostic — it measures consecutive
    idle time, not accumulated timeouts."""
    import threading
    import time

    cfg = tiny_config(m=16, n=8)
    ex = StreamingExecutor(cfg, batch=4, processor=lambda p: (p, p),
                           lockstep=True, stall_warning_s=1.4)
    alive = threading.Event()
    t = threading.Thread(target=alive.wait, daemon=True)
    t.start()
    ex._ingest_threads = [t]
    c, m, n = cfg.sector_shape

    def feed():
        for s in range(4):
            ex._queue.put(SectorTask(np.zeros((c, 2, m, n), np.float32),
                                     s, 0))
            time.sleep(0.8)   # > one get timeout, < stall_warning_s

    threading.Thread(target=feed, daemon=True).start()
    tasks = ex._drain_batch()
    alive.set()
    assert len(tasks) == 4
    assert ex.stall_warnings == 0
