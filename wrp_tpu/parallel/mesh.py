"""Device-mesh construction for the sharded pipelines.

The reference's only scaling axes were CUDA streams (pipelining, one GPU)
and the 143x9 sector/elevation loop (SURVEY.md section 2.5).  Here the
sector loop becomes the data-parallel mesh axis and the in-sector matrix
axes become the sequence-parallel axis.  Every card reaches every other
at the same rate, so the mesh follows the algorithm alone.

Axes:
  * "data" — sectors/elevations (embarrassingly parallel batch axis)
  * "seq"  — the in-sector pulse/range split (transpose-FFT style), for
    scaling a single sector's latency or when batch < device count
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_mesh(
    data: int | None = None,
    seq: int = 1,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Mesh over `devices` (default: all) with shape [data, seq].

    data=None takes every remaining device.
    """
    devs = list(devices if devices is not None else jax.devices())
    if data is None:
        if len(devs) % seq:
            raise ValueError(f"{len(devs)} devices not divisible by seq={seq}")
        data = len(devs) // seq
    n = data * seq
    if n > len(devs):
        raise ValueError(f"mesh {data}x{seq} needs {n} devices, have {len(devs)}")
    arr = np.asarray(devs[:n]).reshape(data, seq)
    return Mesh(arr, (DATA_AXIS, SEQ_AXIS))


def iq_sharding(mesh: Mesh) -> NamedSharding:
    """Planar IQ [batch, channel, 2, m, n]: batch over data, pulses over
    seq."""
    return NamedSharding(mesh, P(DATA_AXIS, None, None, None, SEQ_AXIS))


def result_sharding(mesh: Mesh) -> NamedSharding:
    """Products [batch, m/2]: batch over data, replicated over seq."""
    return NamedSharding(mesh, P(DATA_AXIS, None))
