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
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def _busy_union(spans) -> float:
    """Union length of (start, end) intervals: overlapping events (two
    streams at once, or nested ones) are counted once."""
    spans = sorted(spans)
    busy = 0
    cur_s, cur_e = None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


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
    print(f"\ndevice busy (union over streams, summed over devices): "
          f"{device_busy_ms(trace):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
