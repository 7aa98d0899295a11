#!/usr/bin/env python3
"""Summarize a torch.profiler Chrome trace: per-kernel device time, the
device-busy union.

Counterpart of tools/xprof_summary.py for the PyTorch + CUDA port
(pano_tpu_torch). The port's CLI writes a Chrome trace under
PANO_TPU_PROFILE=<dir> (`pano_torch.sh perf`); bench_torch.py reads one
for its `device_compute_ms`. The trace is JSON, so no schema is needed.

Usage:
  python tools/torch_trace_summary.py <trace_dir_or_json> [--top 30] [--by-stream]

The device work is the events whose `cat` is `kernel`, `gpu_memcpy` or
`gpu_memset`: `ts` and `dur` in microseconds, `pid` the device, `tid`
the stream. CUDA streams carry different work (a TPU plane's lines show
one execution at several granularities, which is why xprof_summary takes
the max over them), so a device's busy time is the union of its events
over every stream, and the total sums the devices. Without device events
(a CPU trace) the table falls back to the host's `cpu_op` events, and
the device-busy time is 0.0.

The port opens `record_function` ranges named `pano.<step>` at its
layers and host steps while a profiler records (`timer.span`); when the
trace holds any, a last table gives per step name: its ranges, the host
ms of its outermost ranges, the CUDA runtime launches its ranges hold on
their own thread (a CUDA graph's launch counts once), the device ms of
the kernels those launches started (by correlation id), and the ms in
which a device sat idle while an outermost range was open (the mean over
the devices).
"""

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The union of (start, end) intervals, and its length: overlapping events
# (two streams at once, or nested ones) count once.
from pano_bench.trace import union as _union  # noqa: E402
from pano_bench.trace import union_length as _busy_union  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "pano."
LAUNCH_NAMES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cuGraphLaunch",
))


def find_trace(path: str) -> str:
    """`path` if it is a file, else the newest *.json (or *.json.gz)
    trace under the directory."""
    if os.path.isfile(path):
        return path
    hits = [h for pat in ("*.json", "*.json.gz")
            for h in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        sys.exit(f"no *.json trace under {path}")
    return max(hits, key=os.path.getmtime)


def load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace if isinstance(trace, dict) else {"traceEvents": trace}


def _complete(trace: dict, cats) -> list:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def _by(events, key) -> dict:
    groups = collections.defaultdict(list)
    for e in events:
        groups[e.get(key)].append(e)
    return groups


def _spans(events) -> list:
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events]


def device_busy_ms(trace: dict) -> float:
    """Device-busy wall time (ms): per device the union of its kernel,
    memcpy and memset intervals over all its streams, summed over the
    devices. 0.0 for a trace without device events."""
    return sum(_busy_union(_spans(evs))
               for evs in _by(_complete(trace, DEVICE_CATS), "pid").values()
               ) / 1e3


def _overlap(a, b) -> float:
    """Length of the intersection of two disjoint sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def program_steps(trace: dict, window=None) -> dict:
    """Per `pano.` step name: {"ranges", "host_ms", "launches",
    "kernel_ms", "idle_ms"} (see the module docstring), over the ranges
    that overlap `window` ((start, end) in us; the whole trace when
    None). Device time is clipped to the window. {} when the trace holds
    no `pano.` range."""
    complete = [e for e in trace.get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]
    if window is None:
        window = (min((float(e["ts"]) for e in complete), default=0.0),
                  max((float(e["ts"]) + float(e["dur"]) for e in complete),
                      default=0.0))
    lo, hi = window
    ranges = collections.defaultdict(list)    # name -> [(s, e, tid)]
    launches = []                              # (ts, correlation, tid)
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    for e in complete:
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith(SPAN_PREFIX) and end > lo \
                and s < hi:
            ranges[e["name"]].append((s, end, e.get("tid")))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and e["name"] in LAUNCH_NAMES:
            launches.append((s, (e.get("args") or {}).get("correlation"),
                             e.get("tid")))
    busy = {}
    for dev, evs in _by(device, "pid").items():
        busy[dev] = _union((max(s, lo), min(e, hi)) for s, e in _spans(evs)
                           if min(e, hi) > max(s, lo))
    idle = {dev: [(a, b) for a, b in zip([lo] + [e for _, e in u],
                                         [s for s, _ in u] + [hi]) if b > a]
            for dev, u in busy.items()}
    kernels = collections.defaultdict(float)   # correlation -> clipped us
    for e in device:
        corr = (e.get("args") or {}).get("correlation")
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") == "kernel" and corr is not None:
            kernels[corr] += max(0.0, min(end, hi) - max(s, lo))
    out = {}
    for name, rs in ranges.items():
        outer = collections.defaultdict(list)  # tid -> disjoint, sorted
        for s, e, tid in sorted(rs, key=lambda r: (r[0], -r[1])):
            if not outer[tid] or s >= outer[tid][-1][1]:
                outer[tid].append((s, e))
        starts = {tid: [s for s, _ in spans] for tid, spans in outer.items()}
        inside = []
        for ts, corr, tid in launches:
            k = bisect.bisect_right(starts.get(tid, []), ts) - 1
            if k >= 0 and ts <= outer[tid][k][1]:
                inside.append(corr)
        flat = [r for spans in outer.values() for r in spans]
        held = _union((max(a, lo), min(b, hi)) for a, b in flat
                      if min(b, hi) > max(a, lo))
        out[name] = {
            "ranges": len(rs),
            "host_ms": sum(e - s for s, e in flat) / 1e3,
            "launches": len(inside),
            "kernel_ms": sum(kernels.get(c, 0.0) for c in set(inside)
                             if c is not None) / 1e3,
            "idle_ms": (sum(_overlap(g, held) for g in idle.values())
                        / len(idle) / 1e3) if idle else 0.0,
        }
    return out


def _steps_table(steps: dict) -> None:
    print("\n=== program steps (pano. ranges) ===")
    width = max(len(n) for n in steps)
    print(f"  {'step':<{width}}  {'ranges':>7}  {'host ms':>10}  "
          f"{'launches':>8}  {'kernel ms':>10}  {'idle ms':>10}")
    for name in sorted(steps):
        v = steps[name]
        print(f"  {name:<{width}}  {v['ranges']:>7}  {v['host_ms']:10.3f}  "
              f"{v['launches']:>8}  {v['kernel_ms']:10.3f}  "
              f"{v['idle_ms']:10.3f}")


def _table(events, top: int) -> None:
    by_name = collections.Counter()
    counts = collections.Counter()
    for e in events:
        by_name[e["name"]] += float(e["dur"]) / 1e3
        counts[e["name"]] += 1
    width = max((len(n) for n, _ in by_name.most_common(top)), default=4)
    for name, ms in by_name.most_common(top):
        print(f"  {name:<{width}}  {ms:9.3f} ms  x{counts[name]}")


def summarize(trace: dict, top: int = 30, by_stream: bool = False) -> None:
    """Per device: its busy time (the union over its streams), then per
    stream its events, busy time and, unless `by_stream`, the `top`
    names by total time. Without device events, the same per host thread
    of `cpu_op` events."""
    events = _complete(trace, DEVICE_CATS)
    unit, lane = "device", "stream"
    if not events:
        events = _complete(trace, ("cpu_op",))
        unit, lane = "host process", "thread"
        if events:
            print("(no device events in trace; summarizing host cpu_op "
                  "events)")
    for pid, dev_events in sorted(_by(events, "pid").items(),
                                  key=lambda kv: str(kv[0])):
        busy = _busy_union(_spans(dev_events)) / 1e3
        print(f"\n=== {unit}: {pid}  events={len(dev_events)}  "
              f"busy={busy:.3f} ms ===")
        for tid, lane_events in sorted(_by(dev_events, "tid").items(),
                                       key=lambda kv: str(kv[0])):
            busy = _busy_union(_spans(lane_events)) / 1e3
            print(f"\n-- {lane}: {tid}  events={len(lane_events)}  "
                  f"busy={busy:.3f} ms")
            if not by_stream:
                _table(lane_events, top)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="trace dir or Chrome trace .json file")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by-stream", action="store_true",
                    help="only per-stream busy totals")
    args = ap.parse_args()
    path = find_trace(args.path)
    print(f"reading {path}")
    trace = load(path)
    summarize(trace, args.top, args.by_stream)
    steps = program_steps(trace)
    if steps:
        _steps_table(steps)
    print(f"\ndevice busy (union over streams, summed over devices): "
          f"{device_busy_ms(trace):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
