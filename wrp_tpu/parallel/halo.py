"""Overlap-save halo exchange for the matched filter on a pulse-sharded
mesh (BASELINE.json configs 4-5; SURVEY.md section 5 'sequence parallelism').

When the pulse axis stays sharded after the Doppler stage (instead of the
all_to_all transpose in sharded.py), stages 05-07's circular convolution
needs each shard's left neighbour's last (ma_count-1) pulse columns:

    conv[j] = sum_k ma[k] * p[(j - k) mod n]

so shard s computes its local columns from [halo from shard s-1 | local],
with the halo moved between devices by one ppermute (circular: shard 0 receives
from shard S-1, completing the mod-n wrap).  The pulse sum then reduces
locally and one psum over the seq axis yields the full stage-08 product.

This is the overlap-save pattern: each shard's output depends only on its
own samples plus a fixed 6-sample (ma_count-1) boundary overlap — the
communication volume is tiny (6 columns x m/2 rows x 4 B = 12 KB per
channel-sector) and is a single neighbour-to-neighbour transfer.

Use when the sector batch is too small to fill the mesh data-parallel and
the transpose's 2 MB-per-sector all_to_all dominates; for the standard
batched pipeline, sharded.py's transpose formulation is faster.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RadarConfig, DEFAULT_CONFIG
from ..constants import PipelineConstants
from .mesh import DATA_AXIS, SEQ_AXIS


def matched_filter_halo(p_loc: jax.Array, ma_taps: np.ndarray,
                        axis_name: str = SEQ_AXIS) -> jax.Array:
    """Per-shard body: local power columns [..., n_loc] -> local
    matched-filter output [..., n_loc], with the (len(taps)-1)-column halo
    fetched from the left (circularly previous) shard via ppermute.

    Must run inside shard_map with `axis_name` a mesh axis whose shards
    partition the pulse axis in order."""
    taps = np.asarray(ma_taps)
    h = len(taps) - 1
    size = lax.axis_size(axis_name)
    if size == 1:
        from ..pipeline import matched_filter_direct

        return matched_filter_direct(p_loc, taps)
    # send my RIGHTMOST h columns to my right neighbour (I receive from
    # the left): ppermute perm maps source->dest shard ids.
    tail = p_loc[..., -h:]
    halo = lax.ppermute(
        tail, axis_name,
        perm=[(i, (i + 1) % size) for i in range(size)],
    )
    ext = jnp.concatenate([halo, p_loc], axis=-1)   # [..., h + n_loc]
    out = taps[0] * ext[..., h:]
    for k in range(1, h + 1):
        out = out + taps[k] * ext[..., h - k:-k]
    return out


def build_halo_processor(cfg: RadarConfig = DEFAULT_CONFIG,
                         mesh: Mesh | None = None):
    """Full-chain step with the pulse axis sharded END-TO-END (no
    transpose): range stage via the A matmul (local — it contracts over
    range rows, which every shard holds in full), Doppler stage via the
    dense B operator COLUMN SHARD (each shard computes only its own output
    pulse columns; the contraction needs all input pulses, gathered once),
    then the halo matched filter + local pulse sum + psum.

    Returns (step, in_sharding): step(iq_planar [B, C, 2, m, n]) ->
    (zdb, zdr) [B, m/2]."""
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh()
    seq = mesh.shape[SEQ_AXIS]
    n = cfg.num_pulses
    if n % seq:
        raise ValueError(f"n={n} must divide by seq={seq}")
    n_loc = n // seq
    halo_cols = len(PipelineConstants.build(cfg).ma_taps) - 1
    if seq > 1 and n_loc < halo_cols:
        # each shard must hold at least the matched filter's overlap:
        # with n_loc < taps-1 the one-hop ppermute halo cannot supply
        # all wrapped columns and the conv would SILENTLY cover the
        # wrong subset (the slices clamp — no shape error downstream
        # because the pulse axis is summed away)
        raise ValueError(
            f"pulse shard n/seq = {n_loc} is smaller than the matched "
            f"filter overlap ({halo_cols} columns); use seq <= "
            f"{n // halo_cols} or the transpose formulation")
    consts = PipelineConstants.build(cfg)

    def body(iq):
        # iq: [b_loc, C, 2, m, n_loc]
        from .. import pipeline

        xr = iq[:, :, 0]
        xi = iq[:, :, 1]
        ar = jnp.asarray(np.ascontiguousarray(consts.op_a_half.real))
        ai = jnp.asarray(np.ascontiguousarray(consts.op_a_half.imag))
        # range stage: contracts over range rows -> fully local per shard
        yr, yi = pipeline._rmatmul(ar, ai, xr, xi, lax.Precision.HIGHEST)

        # Doppler stage: z[:, j] needs ALL pulses; gather y once (the
        # all_gather moves m/2 x n_loc x 2 floats per shard), then apply
        # only this shard's B columns.
        col0 = lax.axis_index(SEQ_AXIS) * n_loc
        br = jnp.asarray(np.ascontiguousarray(consts.op_b.real))
        bi = jnp.asarray(np.ascontiguousarray(consts.op_b.imag))
        br_loc = lax.dynamic_slice_in_dim(br, col0, n_loc, axis=1)
        bi_loc = lax.dynamic_slice_in_dim(bi, col0, n_loc, axis=1)
        yr_all = lax.all_gather(yr, SEQ_AXIS, axis=-1, tiled=True)
        yi_all = lax.all_gather(yi, SEQ_AXIS, axis=-1, tiled=True)
        zr, zi = pipeline._rmatmul(yr_all, yi_all, br_loc, bi_loc,
                                   lax.Precision.HIGHEST)
        p_loc = zr * zr + zi * zi                     # [b, C, m/2, n_loc]

        # stages 05-07 via overlap-save halo; stage 08 local + psum
        conv = matched_filter_halo(p_loc, consts.ma_taps)
        pow_loc = jnp.sum(conv, axis=-1)
        pow_all = lax.psum(pow_loc, SEQ_AXIS)

        gain = jnp.asarray(consts.gain)
        return pipeline.stage09_10_products(pow_all[:, 0], pow_all[:, 1],
                                            gain)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(DATA_AXIS, None, None, None, SEQ_AXIS),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
        check_vma=False,
    )
    from .mesh import iq_sharding

    return jax.jit(sharded), iq_sharding(mesh)
