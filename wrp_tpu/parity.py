"""Parity of a compiled route against the fp64 oracle, with its limits.

One metric everywhere: the reference's relative L2 (error.cpp via
oracle.relative_l2).  The limits hold on the card at full width:

* zdb below 1e-5;
* zdr below 5e-4 — synthetic noise gives a near-zero zdr field
  (~+-1.3 dB), so its relative metric divides by a small norm: 5e-4
  relative is ~1e-4 dB absolute;
* channel power on the adversarial clip-bin field
  (oracle.adversarial_clip_iq) below 2e-5.
"""

from __future__ import annotations

import numpy as np

from . import oracle
from .config import RadarConfig

LIMITS = {"zdb": 1e-5, "zdr": 5e-4, "adversarial": 2e-5}


def route_parity(proc, cfg: RadarConfig, device=None, seed: int = 42,
                 count: int = 2) -> dict:
    """Relative L2 of a SectorProcessor's products on `count` noise
    sectors, and of its channel power on the adversarial field, against
    the fp64 oracle; "ok" when all are inside LIMITS."""
    import jax

    from .pipeline import to_planar

    iq = np.stack([oracle.synthetic_iq(cfg, kind="noise", seed=seed + k)
                   for k in range(count)])
    zdb, zdr = proc(jax.device_put(to_planar(iq), device))
    zdb, zdr = np.asarray(zdb), np.asarray(zdr)
    truth = [oracle.process_sector(iq[k], cfg) for k in range(count)]
    adv = oracle.adversarial_clip_iq(cfg, seed)
    got = np.asarray(proc.power(jax.device_put(to_planar(adv)[None],
                                               device)))[0]
    out = {
        "zdb": max(oracle.relative_l2(truth[k][0], zdb[k])
                   for k in range(count)),
        "zdr": max(oracle.relative_l2(truth[k][1], zdr[k])
                   for k in range(count)),
        "adversarial": oracle.relative_l2(oracle.channel_power(adv, cfg),
                                          got),
        # the dot precision; the fft formulation has no dots
        "precision": None if proc.method == "fft" else proc.precision,
    }
    out["ok"] = all(out[k] < lim for k, lim in LIMITS.items())
    return out
