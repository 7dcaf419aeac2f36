"""On-device wire decode: raw interleaved big-endian int16 -> planar i16.

The host-side decoder (io/codec.py, native/codec.cpp) costs host cores
per sector; a site where host cores, not the card, are scarce can ship
the raw wire bytes instead and decode on the device inside the chain's
jit (`stream --device-decode`, SectorProcessor(wire_input=True)).  The
decode is byteswap + channel/IQ deinterleave (+ optional radix row
reorder) as six fused per-plane byte-slice passes — no transpose op.
The H2D traffic is unchanged (the wire IS int16: 12 B/sample either
way).  `bench.py --in-dtype wire` measures what it costs on the device.

Wire format (reference sector.cpp:52-62, read_single.cc:15): one
sector = m*n samples x 12 bytes, each sample interleaved big-endian
int16 ``hhI hhQ vvI vvQ vhI vhQ``.  Parity with the host decoder is
pinned to exact int16 equality in tests/test_codec.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RadarConfig, DEFAULT_CONFIG
from ..io.codec import radix_row_order


def decode_wire_i16(wire_u8: jax.Array,
                    cfg: RadarConfig = DEFAULT_CONFIG,
                    radix: int = 1,
                    num_pulses: int | None = None) -> jax.Array:
    """uint8 [..., m*n*ch*4] wire bytes -> int16 [..., ch, 2, m, n].

    Matches io/codec.decode_iq_i16 bit-exactly (big-endian int16
    deinterleave, optional radix row reorder).  All arithmetic is int32;
    the data movement is one contiguous row gather (the radix order)
    plus six strided byte-slice passes — no transpose op.

    num_pulses overrides cfg's pulse count: the pulse-sharded wire path
    (parallel/sharded.py wire_input) feeds each device only its 1/seq
    pulse-byte columns, so the per-device decode runs at n/seq — byte
    layout per row is unchanged (the wire interleaves channels per
    SAMPLE, so a pulse-column byte slice is self-contained).
    """
    m, n, ch = cfg.num_range_cells, cfg.num_pulses, cfg.num_channels
    if num_pulses is not None:
        n = num_pulses
    nbytes = m * n * cfg.bytes_per_sample
    lead = wire_u8.shape[:-1]
    if wire_u8.dtype != jnp.uint8 or wire_u8.shape[-1] != nbytes:
        raise ValueError(
            f"expected uint8 [..., {nbytes}] wire bytes; got "
            f"{wire_u8.dtype} {wire_u8.shape}")
    # Per-plane strided BYTE slices with the int16 compose fused into
    # each slice: a [m, n, ch, 2] -> [ch, 2, m, n] transpose moves
    # 6-element minor tiles, while each slice pass reads only its bytes.
    rows = wire_u8.reshape(*lead, m, n * cfg.bytes_per_sample)
    if radix > 1:
        # the ONE canonical permutation (shared with the host decoder) —
        # a drifting copy here would break the bit-parity contract
        # silently.  Applied to the RAW byte rows (contiguous 6 KB row
        # gather) so the downstream slice passes read ordered rows.
        order = radix_row_order(m, radix)
        rows = jnp.take(rows, jnp.asarray(order), axis=len(lead))
    b = rows.reshape(*lead, m, n, ch * 2, 2)
    planes = []
    for k in range(ch * 2):
        v = b[..., k, 0].astype(jnp.int32) * 256 \
            + b[..., k, 1].astype(jnp.int32)     # 0..65535 big-endian
        v = jnp.where(v >= 32768, v - 65536, v)  # sign per int16
        planes.append(v.astype(jnp.int16))
    planar = jnp.stack(planes, axis=len(lead))   # [..., ch*2, m, n]
    return planar.reshape(*lead, ch, 2, m, n)
