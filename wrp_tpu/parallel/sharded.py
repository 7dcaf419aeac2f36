"""Multi-device sharded pipeline via shard_map + collectives.

Parallel decomposition (nothing like it exists in the single-GPU
reference — see SURVEY.md section 2.5 for the mapping):

* data axis  — sectors are independent problems (143 x 9 per volume scan);
  the batch axis is sharded data-parallel.  Zero communication.

* seq axis   — inside a sector the chain alternates between "needs the full
  range axis" (window + range FFT / the A matmul) and "needs the full pulse
  axis" (Doppler + matched filter / the B matmul / the Parseval epilogue).
  We use the classic distributed-FFT transpose: run stage A with pulses
  sharded, one all_to_all to re-shard onto range bins, run the pulse
  stages locally, then a small all_gather of the [m/2] products.

Per sector-shard the all_to_all moves m/2 x n/seq complex64 (2 MB at the
default geometry); on GPUs XLA hands the collectives to NCCL, and every
card reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RadarConfig, DEFAULT_CONFIG
from ..constants import PipelineConstants
from .. import pipeline
from .mesh import DATA_AXIS, SEQ_AXIS, iq_sharding

#: Formulations the transpose body implements.
SHARD_METHODS = ("fft", "parseval", "mxu")


def _shard_body(
    iq: jax.Array,
    consts: PipelineConstants,
    cfg: RadarConfig,
    method: str,
    seq_size: int,
    precision,
    wire_input: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Per-device body: planar iq [b_loc, C, 2, m, n_loc] (float32 or
    int16) -> (zdb, zdr) [b_loc, m/2].  With wire_input the local block
    is raw wire bytes [b_loc, m, n_loc*bps] uint8 — this device's
    pulse-byte columns — decoded here (ops/device_codec).  All-real
    dataflow (complex only transiently inside the fft method)."""
    m, n = cfg.num_range_cells, cfg.num_pulses
    n_loc = n // seq_size
    if wire_input:
        from ..ops.device_codec import decode_wire_i16

        iq = decode_wire_i16(iq.reshape(iq.shape[0], -1), cfg,
                             num_pulses=n_loc)
    xr = iq[:, :, 0].astype(jnp.float32)
    xi = iq[:, :, 1].astype(jnp.float32)

    if method in ("mxu", "parseval"):
        ar = jnp.asarray(np.ascontiguousarray(consts.op_a_half.real))
        ai = jnp.asarray(np.ascontiguousarray(consts.op_a_half.imag))
        if method == "parseval":
            yr, yi = pipeline._rmatmul_gauss(ar, ai, ar + ai, xr, xi,
                                             precision)
        else:
            yr, yi = pipeline._rmatmul(ar, ai, xr, xi, precision)
        y = jnp.stack([yr, yi], axis=2)                   # [b, C, 2, m/2, n_loc]
    elif method == "fft":
        # Window: range factor is local-full; pulse factor needs this
        # shard's slice of global pulse indices.
        from ..constants import hamming_factors

        wr, wd, c = hamming_factors(cfg)
        wr = jnp.asarray(wr * c, jnp.float32)
        wd = jnp.asarray(wd, jnp.float32)
        col0 = lax.axis_index(SEQ_AXIS) * n_loc
        wd_loc = lax.dynamic_slice(wd, (col0,), (n_loc,))
        x = lax.complex(xr, xi) * (wr[:, None] * wd_loc[None, :])
        x = jnp.fft.fft(x, axis=-2)                       # full m local
        x = x[..., : m // 2, :]                           # stage-04 crop early
        y = jnp.stack([jnp.real(x), jnp.imag(x)], axis=2)
    else:
        raise ValueError(f"unknown shard method {method!r}: use one of "
                         f"{SHARD_METHODS}")

    if seq_size > 1:
        # transpose: sharded-on-pulses -> sharded-on-range-bins
        y = lax.all_to_all(y, SEQ_AXIS, split_axis=3, concat_axis=4, tiled=True)
        # y: [b, C, 2, (m/2)/seq, n]

    if method == "parseval":
        pow_loc = pipeline.stage_b_parseval(
            y[:, :, 0], y[:, :, 1], jnp.asarray(consts.wd),
            jnp.asarray(consts.clip_phasors), precision)
    else:
        if method == "mxu":
            br = jnp.asarray(np.ascontiguousarray(consts.op_b.real))
            bi = jnp.asarray(np.ascontiguousarray(consts.op_b.imag))
            zr, zi = pipeline._rmatmul(y[:, :, 0], y[:, :, 1], br, bi,
                                       precision)
            p = zr * zr + zi * zi
        else:
            yc = lax.complex(y[:, :, 0], y[:, :, 1])
            mean = jnp.mean(yc, axis=-1, keepdims=True)
            z = jnp.conj(yc - mean)
            z = jnp.fft.fft(z, axis=-1)
            z = jnp.conj(jnp.roll(z, n // 2, axis=-1))
            z = z.at[..., n - 2 :].set(0.0)
            p = jnp.real(z) ** 2 + jnp.imag(z) ** 2
        conv = pipeline.matched_filter_direct(p, consts.ma_taps)
        pow_loc = jnp.sum(conv, axis=-1)                  # [b, C, (m/2)/seq]

    if seq_size > 1:
        pow_all = lax.all_gather(pow_loc, SEQ_AXIS, axis=2, tiled=True)
    else:
        pow_all = pow_loc

    gain = jnp.asarray(consts.gain)
    return pipeline.stage09_10_products(pow_all[:, 0], pow_all[:, 1], gain)


def build_sharded_processor(
    cfg: RadarConfig = DEFAULT_CONFIG,
    mesh: Mesh | None = None,
    method: str = pipeline.DEFAULT_METHOD,
    wire_input: bool = False,
    precision: str | None = None,
):
    """Returns (step, in_sharding): `step(iq_planar[B, C, 2, m, n]) ->
    (zdb, zdr)`, jit-compiled over the mesh.  Use `shard_batch(iq, mesh,
    in_sharding)` to lay out the input.

    method: one of SHARD_METHODS, transpose-FFT seq sharding — B must
    divide by the data-axis size; n and m/2 by the seq-axis size.  A
    data x 1 mesh is pure data-parallel (the all_to_all degenerates
    away).  precision: a pipeline.PRECISIONS key (default: the
    platform's).  wire_input=True takes raw wire BYTES [B, m, n*bps]
    uint8 with the pulse-byte columns sharded over seq; each device
    decodes its slice on-device — the --device-decode deployment option
    under pulse sharding.
    """
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()
    seq_size = mesh.shape[SEQ_AXIS]
    if cfg.num_pulses % seq_size or (cfg.num_range_cells // 2) % seq_size:
        raise ValueError(
            f"n={cfg.num_pulses} and m/2={cfg.num_range_cells // 2} must "
            f"divide by seq={seq_size}"
        )
    if method not in SHARD_METHODS:
        raise ValueError(f"unknown shard method {method!r}: use one of "
                         f"{SHARD_METHODS}")
    consts = PipelineConstants.build(cfg)
    prec = pipeline.PRECISIONS[
        precision or pipeline.precision_for(mesh.devices.flat[0].platform)]

    body = functools.partial(
        _shard_body, consts=consts, cfg=cfg, method=method,
        seq_size=seq_size, precision=prec, wire_input=wire_input,
    )
    if wire_input:
        in_spec = P(DATA_AXIS, None, SEQ_AXIS)
        in_sharding = NamedSharding(mesh, in_spec)
    else:
        in_spec = P(DATA_AXIS, None, None, None, SEQ_AXIS)
        in_sharding = iq_sharding(mesh)
    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=in_spec,
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        # Outputs are seq-replicated by construction (all_gather of the
        # final [m/2] products); the static VMA tracker can't prove it.
        check_vma=False,
    )
    step = jax.jit(sharded)
    return step, in_sharding


def shard_batch(iq: np.ndarray, mesh: Mesh,
                sharding=None) -> jax.Array:
    """Host batch -> device array laid out for the sharded processor.

    Accepts complex [B, C, m, n] (converted to planar host-side) or planar
    float32 [B, C, 2, m, n].  `sharding` overrides the default transpose-FFT
    layout (pass the in_sharding returned by build_sharded_processor)."""
    if np.iscomplexobj(iq):
        iq = pipeline.to_planar(np.asarray(iq))
    return jax.device_put(iq, sharding if sharding is not None
                          else iq_sharding(mesh))
