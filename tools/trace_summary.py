#!/usr/bin/env python
"""Summarise a jax.profiler trace (bench.py --profile DIR) into op-level
time totals — the nvprof-style per-kernel hot list (SURVEY.md section 6)
for device runs, without needing tensorboard.

The profiler writes chrome-trace JSON under
DIR/plugins/profile/<run>/ (<host>.trace.json.gz, or perfetto_trace.json.gz
with create_perfetto_trace=True); complete events ("ph":"X")
carry name + dur (microseconds).  We aggregate wall time per event name,
per process/"resource" (device streams vs host threads), and print the top-N.

Usage: python tools/trace_summary.py /tmp/trace_dir [--top 25]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_traces(root):
    pats = [
        os.path.join(root, "plugins", "profile", "*", "*.trace.json.gz"),
        os.path.join(root, "plugins", "profile", "*",
                     "perfetto_trace.json.gz"),
        os.path.join(root, "**", "*.trace.json.gz"),
        os.path.join(root, "**", "*.trace.json"),
    ]
    out = []
    for p in pats:
        out.extend(glob.glob(p, recursive=True))
        if out:
            break
    return sorted(set(out))


def load_events(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    return doc.get("traceEvents", [])


def summarise(events, top=25):
    # map pid -> process name (e.g. "/device:GPU:0" vs host threads)
    pnames = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pnames[e["pid"]] = e.get("args", {}).get("name", str(e["pid"]))
    per_proc = collections.defaultdict(
        lambda: collections.defaultdict(float))
    counts = collections.defaultdict(
        lambda: collections.defaultdict(int))
    spans = collections.defaultdict(lambda: [float("inf"), 0.0])
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        proc = pnames.get(e.get("pid"), str(e.get("pid")))
        name = e.get("name", "?")
        per_proc[proc][name] += e["dur"]
        counts[proc][name] += 1
        s = spans[proc]
        s[0] = min(s[0], e["ts"])
        s[1] = max(s[1], e["ts"] + e["dur"])
    out = {}
    for proc, totals in per_proc.items():
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        span = spans[proc][1] - spans[proc][0]
        out[proc] = {
            "span_ms": round(span / 1e3, 3),
            "ops": [
                {"name": n, "total_ms": round(t / 1e3, 3),
                 "calls": counts[proc][n],
                 "pct_of_span": round(100 * t / span, 1) if span else 0.0}
                for n, t in rows
            ],
        }
    return out


def _union(intervals):
    """Merge [t0, t1) spans; returns (merged list, total length)."""
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged, sum(t1 - t0 for t0, t1 in merged)


def _intersect_len(a, b):
    """Total overlap length of two MERGED span lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def summarise_overlap(intervals):
    """Pairwise overlap fractions from the executor's host-interval log
    (StageTimers.enable_intervals: [name, thread, t0, t1] rows).

    The question the totals can't answer: while a batch was IN FLIGHT on
    the device (compute/in_flight spans: H2D enqueue + dispatch through
    the blocking fetch), was the host concurrently ingesting/decoding the
    next sectors — i.e. does the two-deep pipeline actually overlap, the
    way the reference proved its CUDA stream cascade with nvprof traces
    (prof/casc*.prof)?"""
    by_name = collections.defaultdict(list)
    for name, _thread, t0, t1 in intervals:
        by_name[name].append((t0, t1))
    merged = {n: _union(v) for n, v in by_name.items()}
    out = {"busy_s": {n: round(tot, 3) for n, (_, tot) in
                      sorted(merged.items())}}
    base_name = "compute/in_flight"
    if base_name in merged:
        base, base_len = merged[base_name]
        rows = {}
        for n, (spans, tot) in merged.items():
            if n == base_name or not base_len:
                continue
            ov = _intersect_len(base, spans)
            rows[n] = {
                # fraction of the stage's own busy time that ran while a
                # batch was in flight on the device
                "of_stage": round(ov / tot, 3) if tot else None,
                # fraction of the device in-flight time this stage
                # covered
                "of_in_flight": round(ov / base_len, 3),
                "overlap_s": round(ov, 3),
            }
        out["in_flight_s"] = round(base_len, 3)
        out["overlap_with_in_flight"] = rows
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--overlap", action="store_true",
                    help="also read DIR/host_intervals.json (written by "
                         "`cli stream --trace` / consolidation_soak "
                         "--trace) and print host-stage overlap "
                         "fractions against the device in-flight window")
    args = ap.parse_args()
    if args.overlap:
        ipath = os.path.join(args.trace_dir, "host_intervals.json")
        if not os.path.exists(ipath):
            print(f"no {ipath}", file=sys.stderr)
            return 1
        with open(ipath) as f:
            ov = summarise_overlap(json.load(f))
        print(json.dumps(ov, indent=1))
        if not find_traces(args.trace_dir):
            return 0
    paths = find_traces(args.trace_dir)
    if not paths:
        print(f"no trace files under {args.trace_dir}", file=sys.stderr)
        return 1
    # Summarise each trace file independently and merge under
    # file-qualified process names: per-host trace files reuse the same
    # pids and have unsynchronised clocks, so concatenating their event
    # lists would sum distinct processes' op totals and corrupt spans.
    summary = {}
    for p in paths:
        per_file = summarise(load_events(p), args.top)
        prefix = "" if len(paths) == 1 else (
            os.path.basename(p).split(".")[0] + ":")
        for proc, info in per_file.items():
            summary[prefix + proc] = info
    if args.json:
        print(json.dumps(summary))
        return 0
    for proc, info in sorted(summary.items()):
        print(f"\n== {proc}  (span {info['span_ms']} ms)")
        for r in info["ops"]:
            print(f"  {r['total_ms']:>10.3f} ms  {r['calls']:>6}x "
                  f"{r['pct_of_span']:>5.1f}%  {r['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
