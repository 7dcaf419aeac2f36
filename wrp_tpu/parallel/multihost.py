"""Multi-host (multi-process) scaling of the radar chain.

Topology: each host runs its own ingest (UDP/TCP/ZMQ, io/) and decodes its
share of sectors into host-local planar batches; the hosts form one global
device mesh and every step processes the *global* batch, data-parallel over
sectors (the workload is 143 x 9 independent sector problems per volume
scan, SURVEY.md section 2.5 — nothing like this exists in the single-GPU
reference).  Per-host results come back addressable locally, so each host
publishes products for exactly the sectors it ingested: the producer ->
processor -> consumer dataflow of the reference (section 1) sharded H ways.

Communication: batch assembly uses jax.make_array_from_process_local_data
(no cross-host data movement — each host's shard stays on its devices);
the compute step is the shard_map pipeline (sharded.py), whose collectives
(all_to_all / all_gather for the optional in-sector seq split) XLA hands
to NCCL on GPUs.

One process per card: a JAX process reserves most of every card it
opens, so a launcher that starts several processes on one machine gives
each its own card (device.card_env — `cli supervise` and chip_smoke.py
do).  Tested with a real 2-process gloo-backed CPU mesh in
tests/test_multihost.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding

from ..config import RadarConfig, DEFAULT_CONFIG
from ..pipeline import DEFAULT_METHOD
from .mesh import DATA_AXIS, SEQ_AXIS, make_mesh
from .sharded import build_sharded_processor


def _gather_local_rows(out: jax.Array) -> np.ndarray:
    """Reassemble this process's addressable shards of a [batch, ...]
    output in batch order (shards arrive unordered)."""
    rows = {}
    for shard in out.addressable_shards:
        start = shard.index[0].start or 0
        rows[start] = np.asarray(shard.data)
    return np.concatenate([rows[k] for k in sorted(rows)], axis=0)


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the jax.distributed world (idempotent).

    coordinator: "host:port" of process 0.  Call before any other jax use.
    The process uses the cards its environment makes visible
    (CUDA_VISIBLE_DEVICES, set per process by its launcher).
    """
    from jax._src import distributed as _dist

    # NB: must not touch jax.devices()/process_count() here — that would
    # initialise the XLA backend before the distributed client exists.
    if getattr(_dist.global_state, "client", None) is not None:
        return
    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id)


@dataclasses.dataclass
class MultiHostProcessor:
    """Global-mesh batch processor with per-host feed/collect.

    Usage (on every process):

        proc = MultiHostProcessor.build(cfg, per_host_batch=16)
        zdb, zdr = proc.step_local(local_planar)   # [16, C, 2, m, n]
        # zdb/zdr are THIS host's [16, m/2] products, ready for egress
    """

    cfg: RadarConfig
    mesh: Mesh
    per_host_batch: int
    _step: Callable
    _in_sharding: NamedSharding
    _local_shape: Tuple[int, ...]

    @classmethod
    def build(cls, cfg: RadarConfig = DEFAULT_CONFIG,
              per_host_batch: int = 16, seq: int = 1,
              method: str = DEFAULT_METHOD) -> "MultiHostProcessor":
        mesh = make_mesh(seq=seq)
        data_size = mesh.shape[DATA_AXIS]
        procs = jax.process_count()
        if (per_host_batch * procs) % data_size:
            raise ValueError(
                f"global batch {per_host_batch * procs} must divide by the "
                f"data axis ({data_size})")
        step, in_sharding = build_sharded_processor(cfg, mesh, method=method)
        c, m, n = cfg.sector_shape
        return cls(cfg=cfg, mesh=mesh, per_host_batch=per_host_batch,
                   _step=step, _in_sharding=in_sharding,
                   _local_shape=(per_host_batch, c, 2, m, n))

    def feed_local(self, local_planar: np.ndarray) -> jax.Array:
        """Host-local planar batch [per_host_batch, C, 2, m, n] float32 ->
        global sharded array [procs * per_host_batch, ...].  Zero cross-host
        transfer: this host's rows land on this host's devices."""
        if local_planar.shape != self._local_shape:
            raise ValueError(
                f"expected {self._local_shape}, got {local_planar.shape}")
        return jax.make_array_from_process_local_data(
            self._in_sharding, np.ascontiguousarray(local_planar))

    def step_global(self, global_iq: jax.Array):
        return self._step(global_iq)

    def collect_local(self, out: jax.Array) -> np.ndarray:
        """Extract this host's rows of a [global_batch, m/2] product (the
        sectors it fed), in feed order."""
        return _gather_local_rows(out)[: self.per_host_batch]

    def step_local(self, local_planar: np.ndarray):
        """feed -> step -> collect: this host's products for its sectors."""
        out = self.step_global(self.feed_local(local_planar))
        return tuple(self.collect_local(o) for o in out)


@dataclasses.dataclass
class PulseShardedProcessor:
    """Sequence parallelism ACROSS hosts: every host ingests the same
    broadcast wire and computes a pulse-axis slice of every sector.

    The reference's ingest is UDP *broadcast* (udpbroadcast.cpp:30 sends
    to INADDR_BROADCAST), so on a LAN every host already receives every
    sector for free — this mode exploits that: instead of splitting the
    sector stream (MultiHostProcessor's data-parallel mode), each of the
    H hosts slices its 1/H share of the pulse columns from the same wire
    bytes and the transpose-FFT seq sharding (sharded.py:38-104) stitches
    the spectra back together with an all_to_all + all_gather that CROSS
    the host boundary (NCCL between cards, gloo on CPU).  Use it to scale a
    single sector's latency when one host's chip is the bottleneck.

    Unlike the data-parallel mode, the per-step program genuinely BLOCKS
    on a silent peer (the all_to_all needs every host's contribution) —
    this is the configuration that exercises the executor's
    collective-timeout bounded abort for real
    (tests/test_multihost.py::test_pulse_sharded_*).

    Mesh layout: the seq axis spans processes (process p owns mesh column
    p), the data axis spans each process's local devices — so the batch
    still splits over local chips while the pulse split rides the
    cross-host links.  Every host feeds the full [B, C, 2, m, n] batch
    and gets the full [B, m/2] products back (seq-replicated outputs),
    so each host can publish/checkpoint the whole volume — N-way
    redundancy instead of N-way sharding.
    """

    cfg: RadarConfig
    mesh: Mesh
    batch: int
    wire_input: bool
    _step: Callable
    _in_sharding: NamedSharding
    _pulse_slice: slice
    _local_shape: Tuple[int, ...]

    @classmethod
    def build(cls, cfg: RadarConfig = DEFAULT_CONFIG, batch: int = 16,
              method: str = DEFAULT_METHOD,
              device_decode: bool = False) -> "PulseShardedProcessor":
        """method: one of sharded.SHARD_METHODS (transpose-FFT seq
        sharding: stage A per pulse slice, cross-host all_to_all, pulse
        stages per range-row slice).

        device_decode: step_local takes raw wire BYTES [batch,
        sector_nbytes_wire] uint8; each host slices its 1/N pulse-byte
        columns and the decode runs on the device inside the step
        (ops/device_codec) — the pulse-shard analogue of
        `stream --device-decode`, for host-core-constrained fleets."""
        procs = jax.process_count()
        local = jax.local_device_count()
        # jax.devices() is process-major: reshape(P, L).T puts process
        # p's devices in mesh column p -> the seq axis crosses hosts
        devs = np.asarray(jax.devices()).reshape(procs, local).T
        mesh = Mesh(devs, (DATA_AXIS, SEQ_AXIS))
        if batch % local:
            raise ValueError(
                f"batch {batch} must divide by local devices ({local})")
        step, in_sharding = build_sharded_processor(
            cfg, mesh, method=method, wire_input=device_decode)
        c, m, n = cfg.sector_shape
        pid = jax.process_index()
        n_loc = n // procs
        local_shape = ((batch, cfg.sector_nbytes_wire) if device_decode
                       else (batch, c, 2, m, n))
        return cls(cfg=cfg, mesh=mesh, batch=batch,
                   wire_input=device_decode, _step=step,
                   _in_sharding=in_sharding,
                   _pulse_slice=slice(pid * n_loc, (pid + 1) * n_loc),
                   _local_shape=local_shape)

    def step_local(self, planar: np.ndarray, labels=None):
        """Full planar batch [batch, C, 2, m, n] (every host passes the
        same sectors, decoded from the shared broadcast wire) ->
        (zdb, zdr) [batch, m/2] — the FULL products, on every host.
        With device_decode the input is instead the raw wire bytes
        [batch, sector_nbytes_wire] uint8 straight off the broadcast
        wire; this host's pulse-byte columns are sliced here and decoded
        on the device inside the step.

        labels: optional [batch, 2] int32 (sector, elevation) rows, -1
        padding.  When given, batch alignment is verified ACROSS HOSTS
        before dispatch: unlike the data-parallel mode, this step mixes
        per-slot pulse columns from every host through the all_to_all,
        so one host dropping a wire sector would silently corrupt every
        product on every host from that slot on.  The check costs one
        tiny host all-gather per batch and turns that silent corruption
        into a loud RuntimeError (which the streaming executor's
        collective-abort path converts into a bounded checkpoint-and-
        exit).  The executor passes labels automatically."""
        if planar.shape != self._local_shape:
            raise ValueError(
                f"expected {self._local_shape}, got {planar.shape}")
        if labels is not None:
            self._check_aligned(labels)
        if self.wire_input:
            # wire rows are [m, n*bps] bytes with channels interleaved
            # per SAMPLE, so this host's pulse columns are a clean byte
            # column slice — 1/N of the wire bytes reach the device
            c, m, n = self.cfg.sector_shape
            bps = self.cfg.bytes_per_sample
            sl = slice(self._pulse_slice.start * bps,
                       self._pulse_slice.stop * bps)
            rows = planar.reshape(self.batch, m, n * bps)
            local = np.ascontiguousarray(rows[:, :, sl])
        else:
            local = np.ascontiguousarray(planar[..., self._pulse_slice])
        g = jax.make_array_from_process_local_data(self._in_sharding, local)
        out = self._step(g)
        # outputs are batch-sharded over this host's local devices
        # (seq-replicated): reassembly yields the FULL batch
        return tuple(_gather_local_rows(o) for o in out)

    def _check_aligned(self, labels) -> None:
        from jax.experimental import multihost_utils

        lab = np.asarray(labels, np.int32)
        if lab.shape != (self.batch, 2):
            raise ValueError(f"labels must be [{self.batch}, 2] "
                             f"(sector, elevation); got {lab.shape}")
        allv = np.asarray(multihost_utils.process_allgather(lab))
        ref = allv[0]
        if not (allv == ref[None]).all():
            bad = np.argwhere((allv != ref[None]).any(axis=2))
            p, i = (int(v) for v in bad[0])
            raise RuntimeError(
                f"pulse-shard batch misaligned across hosts: slot {i} "
                f"is (sector, elevation) {tuple(ref[i])} on host 0 but "
                f"{tuple(allv[p, i])} on host {p} — a feed dropped or "
                f"reordered a wire sector; aborting before the "
                f"all_to_all mixes pulse columns from different sectors")

