#!/usr/bin/env python
"""Headline benchmark: full 11-stage chain, sectors/second on the GPU.

Methodology matches the reference's best-trace measurement (BASELINE.md):
device-resident input, span = first kernel to last result (the reference's
'nocin' traces exclude host stdin ingest).  Host->device transfer is
measured separately and reported as extra fields.

Baseline to beat: 36.1 sectors/s for the 3-channel chain on the reference's
GeForce 930M (prof/g7.prof); 73.5 sectors/s for 2-channel (nocin-sep.prof).

    python bench.py                  # the flagship route, one JSON line
    python bench.py --routes         # every formulation x dot precision
    python bench.py --smoke          # tiny CPU run of the harness itself

Without a GPU every mode but --smoke exits non-zero: a CPU timing is not
a device number.  Each result names the device (platform, kind, count)
and the card's name and power limit.
"""

import argparse
import json
import sys
import time


BASELINE_3CH = 36.1   # prof/g7.prof, GeForce 930M
BASELINE_2CH = 73.5   # prof/nocin-sep.prof

#: Bound on the salted harness's cancellation residual against the
#: unsalted step (relative L2 of zdb); the oracle limits are
#: wrp_tpu.parity.LIMITS.
SALT_LIMIT = 1e-3


def parse_args(argv=None):
    from wrp_tpu.pipeline import DEFAULT_METHOD, METHODS, PRECISIONS

    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CPU-safe run")
    ap.add_argument("--batch", type=int, default=128, help="sectors per step")
    ap.add_argument("--distinct", type=int, default=2,
                    help="distinct device-staged batches the loop cycles")
    ap.add_argument("--repeats", type=int, default=48,
                    help="passes over the distinct batches in one span")
    ap.add_argument("--method", default=DEFAULT_METHOD, choices=METHODS)
    ap.add_argument("--precision", default=None, choices=sorted(PRECISIONS),
                    help="dot precision (default: the platform's, "
                         "pipeline.PRECISION_BY_PLATFORM)")
    ap.add_argument("--matched-filter", default="direct",
                    choices=["direct", "fold", "spectral"])
    ap.add_argument("--channels", type=int, default=3, choices=[2, 3],
                    help="2 compares against the reference's 2-channel "
                         "nocin baseline (73.5 sectors/s)")
    ap.add_argument("--in-dtype", default="i16",
                    choices=["f32", "i16", "wire"],
                    help="staged input: int16 planar (the wire-native "
                         "compact feed, cast on the device), float32 "
                         "planar, or RAW wire bytes decoded on the "
                         "device inside the timed span (ops/device_codec)")
    ap.add_argument("--routes", action="store_true",
                    help="time every formulation under every dot "
                         "precision on one staging: one JSON line per "
                         "route, then a summary line")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="run the step data-parallel over an N-device "
                         "mesh (parallel/sharded.py); the salted loop "
                         "wraps the sharded step")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of one timed pass")
    return ap.parse_args(argv)


def stage_host(cfg, args, rng):
    """Host staging [D, B, ...]: int16/float32 planar IQ, or the same
    samples as raw wire bytes (interleaved big-endian int16)."""
    import numpy as np

    c, m, n = cfg.sector_shape
    iq = rng.integers(-8192, 8192, (args.distinct, args.batch, c, 2, m, n),
                      dtype=np.int16)
    if args.in_dtype == "f32":
        return iq.astype(np.float32)
    if args.in_dtype == "wire":
        return np.ascontiguousarray(iq.transpose(0, 1, 4, 5, 2, 3),
                                    ">i2").view(np.uint8).reshape(
                                        args.distinct, args.batch, -1)
    return iq


def make_timed(cfg, step, args, wire: bool):
    """jit(staged) -> accumulator: `distinct * repeats` steps, step i
    reading staged slab i % D plus a per-step SALT the chain cancels.

    The salt is s_i / wd[j] (inverse pulse window): after the stage-01
    window it is constant along the pulse axis, and the chain's mean
    subtraction removes it exactly in exact arithmetic (to fp rounding
    in practice — checked against the unsalted step before timing).  No
    two steps compute the same function of the same data, so XLA cannot
    hoist or reuse work across steps, and every output element feeds the
    carry, so nothing is dead."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from wrp_tpu.constants import hamming_factors
    from wrp_tpu.ops.device_codec import decode_wire_i16

    _, wd, _ = hamming_factors(cfg)
    inv_wd = jnp.asarray(1.0 / wd, jnp.float32)
    steps = args.distinct * args.repeats

    def salted(x, i=None):
        """Staged slab -> float32 planar input of step i (unsalted when
        i is None)."""
        if wire:
            x = decode_wire_i16(x, cfg)
        x = x.astype(jnp.float32)
        if i is None:
            return x
        return x + (jnp.float32(8.0) * (i % 127 + 1)) * inv_wd

    @jax.jit
    def timed(staged):
        def one_step(i, carry):
            x = lax.dynamic_index_in_dim(staged, i % args.distinct,
                                         keepdims=False)
            zdb, zdr = step(salted(x, i))
            return carry + jnp.sum(zdb, axis=0) + jnp.sum(
                jnp.where(jnp.isfinite(zdr), zdr, 0.0), axis=0)

        return lax.fori_loop(0, steps, one_step,
                             jnp.zeros(cfg.num_output_bins, np.float32))

    return timed, salted, steps


def run_route(cfg, args, method, precision, dev_staged, dev, step=None):
    """Compile, parity-check and time one route.  Returns a dict; a
    compile failure lands as {"compile": "failed", "error": ...}."""
    import jax
    import numpy as np

    from wrp_tpu.oracle import relative_l2
    from wrp_tpu.parity import route_parity
    from wrp_tpu.pipeline import SectorProcessor

    # the dot precision; the fft formulation has no dots
    rec = {"method": method,
           "precision": None if method == "fft" else precision}
    proc = SectorProcessor(cfg, method=method, precision=precision,
                           matched_filter=args.matched_filter, device=dev)
    step = step or proc
    timed, salted, steps = make_timed(cfg, step, args,
                                      args.in_dtype == "wire")
    t0 = time.perf_counter()
    try:
        compiled = timed.lower(dev_staged).compile()
        np.asarray(compiled(dev_staged))
    except Exception as e:      # recorded, not hidden: see the route table
        rec.update(compile="failed", error=f"{type(e).__name__}: {e}"[:400])
        return rec, None
    rec["compile"] = "ok"
    rec["compile_s"] = round(time.perf_counter() - t0, 3)
    mem = compiled.memory_analysis()
    if mem is not None:
        rec["temp_bytes"] = int(mem.temp_size_in_bytes)

    # harness self-check: the salted step reproduces the unsalted one
    x0 = dev_staged[0]
    ref = np.asarray(jax.jit(lambda x: step(salted(x)))(x0)[0])
    got = np.asarray(jax.jit(lambda x: step(salted(x, 7)))(x0)[0])
    par = route_parity(proc, cfg, dev)
    par["salted"] = relative_l2(ref, got)
    rec["parity"] = par
    rec["parity_ok"] = bool(par["ok"] and par["salted"] < SALT_LIMIT)

    if args.profile:
        with jax.profiler.trace(args.profile, create_perfetto_trace=True):
            np.asarray(compiled(dev_staged))
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        acc = np.asarray(compiled(dev_staged))
        runs.append(time.perf_counter() - t0)
    if not np.isfinite(acc[1:]).all():
        rec["parity_ok"] = False
        rec["error"] = "non-finite zdb accumulator"
    sps = steps * args.batch / min(runs)
    rec.update(sectors_per_second=sps, us_per_sector=1e6 / sps,
               timed_runs_s=runs, steps=steps)
    return rec, proc


def h2d_rates(cfg, args, proc, host, dev):
    """(GB/s of one bulk H2D, sectors/s with one batch's H2D + compute
    + D2H in series, sectors/s with the next batch's H2D overlapped as
    the streaming executor does)."""
    import jax
    import numpy as np

    from wrp_tpu.pipeline import SectorProcessor

    if args.in_dtype == "wire":
        proc = SectorProcessor(cfg, method=proc.method,
                               precision=proc.precision, device=dev,
                               wire_input=True)
    slabs = list(host)

    def fetch(out):
        return np.asarray(out[0]), np.asarray(out[1])

    t0 = time.perf_counter()
    jax.block_until_ready(jax.device_put(host, dev))
    gbps = host.nbytes / (time.perf_counter() - t0) / 1e9
    fetch(proc(jax.device_put(slabs[0], dev)))          # compile
    t0 = time.perf_counter()
    fetch(proc(jax.device_put(slabs[0], dev)))
    serial = args.batch / (time.perf_counter() - t0)

    npipe = max(4, 2 * len(slabs))
    d_cur = jax.device_put(slabs[0], dev)
    prev = None
    t0 = time.perf_counter()
    for k in range(npipe):
        out_k = proc(d_cur)
        d_cur = jax.device_put(slabs[(k + 1) % len(slabs)], dev)
        if prev is not None:
            fetch(prev)
        prev = out_k
    fetch(prev)
    jax.block_until_ready(d_cur)
    piped = npipe * args.batch / (time.perf_counter() - t0)
    return gbps, serial, piped


def sharded_step(cfg, args, method, precision):
    """(step, step input sharding, staged sharding) of the data-parallel
    sharded processor on an N x 1 mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wrp_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from wrp_tpu.parallel.sharded import build_sharded_processor

    if args.batch % args.sharded:
        sys.exit(f"--batch {args.batch} must divide by --sharded "
                 f"{args.sharded}")
    if args.in_dtype == "wire":
        sys.exit("--sharded stages planar input; use --in-dtype i16/f32")
    mesh = make_mesh(data=args.sharded, seq=1)
    step, in_sharding = build_sharded_processor(cfg, mesh, method=method,
                                                precision=precision)
    return step, in_sharding, NamedSharding(
        mesh, P(None, DATA_AXIS, None, None, None, None))


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import jax

    from wrp_tpu import DEFAULT_CONFIG, tiny_config
    from wrp_tpu.device import (NoGPUError, card_name_power, device_record,
                                enable_compile_cache, require_gpu)
    from wrp_tpu.parity import LIMITS
    from wrp_tpu.pipeline import METHODS, PRECISIONS, precision_for

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
        cfg = tiny_config(m=128, n=64, channels=args.channels)
        args.batch, args.distinct, args.repeats = 4, 2, 2
    else:
        cfg = DEFAULT_CONFIG
        if args.channels != cfg.num_channels:
            import dataclasses

            cfg = dataclasses.replace(
                cfg, num_channels=args.channels).validate()
    enable_compile_cache()
    if args.smoke:
        dev_rec = device_record()
    else:
        try:
            dev_rec = require_gpu()
        except NoGPUError as e:
            print(str(e), file=sys.stderr)
            return 2
    card = card_name_power()
    dev = jax.devices()[0]
    log = ((lambda *a: print(*a, file=sys.stderr)) if args.verbose
           else (lambda *a: None))
    log(f"device: {dev} ({card}), batch {args.batch}")
    precision = args.precision or precision_for(dev.platform)
    common = {"device": dev_rec, "card": card, "batch": args.batch,
              "in_dtype": args.in_dtype,
              "geometry": f"{cfg.num_channels}x{cfg.m}x{cfg.n}"}

    rng = np.random.default_rng(0)
    host = stage_host(cfg, args, rng)

    if args.routes:
        dev_staged = jax.block_until_ready(jax.device_put(host, dev))
        rows = []
        for method in METHODS:
            precs = [None] if method == "fft" else sorted(PRECISIONS)
            for prec in precs:
                try:
                    rec, _ = run_route(cfg, args, method, prec, dev_staged,
                                       dev)
                except Exception as e:   # recorded in the table, not hidden
                    rec = {"method": method, "precision": prec,
                           "error": f"{type(e).__name__}: {e}"[:400]}
                rec.update(common)
                rows.append(rec)
                print(json.dumps(rec), flush=True)
        ok = [r for r in rows if r.get("parity_ok")]
        best = max(ok, key=lambda r: r["sectors_per_second"], default=None)
        print(json.dumps({
            "metric": "route_table", **common,
            "fastest_within_tolerance": (
                None if best is None
                else {k: best[k] for k in ("method", "precision",
                                           "sectors_per_second",
                                           "us_per_sector")}),
            "limits": {**LIMITS, "salted": SALT_LIMIT}}))
        return 0 if best is not None else 1

    step = None
    if args.sharded:
        step, in_sharding, staged_sharding = sharded_step(
            cfg, args, args.method, precision)
        dev_staged = jax.block_until_ready(
            jax.device_put(host, staged_sharding))
    else:
        dev_staged = jax.block_until_ready(jax.device_put(host, dev))
    rec, proc = run_route(cfg, args, args.method, precision, dev_staged,
                          dev, step=step)
    if rec["compile"] != "ok" or not rec["parity_ok"]:
        print(json.dumps({"error": "route failed its compile or parity "
                                   "gate", **rec, **common}))
        return 1
    if args.sharded:
        # the sharded step against the single-device processor on the
        # same sectors
        from wrp_tpu.oracle import relative_l2

        x = host[0].astype(np.float32)
        zdb_u = np.asarray(proc(jax.device_put(x, dev))[0])
        zdb_s = np.asarray(step(jax.device_put(x, in_sharding))[0])
        rec.update(sharded_devices=args.sharded,
                   sharded_parity_rel_l2=relative_l2(zdb_u, zdb_s))
    else:
        gbps, serial, piped = h2d_rates(cfg, args, proc, host, dev)
        rec.update(h2d_gbps=gbps, sectors_per_second_with_h2d=serial,
                   sectors_per_second_with_h2d_pipelined=piped)
    baseline = BASELINE_3CH if cfg.num_channels == 3 else BASELINE_2CH
    sps = rec["sectors_per_second"]
    print(json.dumps({
        "metric": f"sectors_per_second_{cfg.num_channels}ch",
        "value": sps, "unit": "sectors/s",
        "vs_baseline": sps / baseline,
        "pulses_per_second": sps * cfg.num_pulses,
        **rec, **common,
        "matched_filter": args.matched_filter,
        "baseline": {"3ch": BASELINE_3CH, "2ch_nocin": BASELINE_2CH,
                     "hw": "GeForce 930M (prof/g7.prof, nocin-sep.prof)"},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
