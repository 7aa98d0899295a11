"""Layer spans around program calls, and the reading of a
``torch.profiler`` Chrome trace into what the per-layer metrics need.

Spans: a ``torch.profiler.record_function`` named ``pano_bench.<layer>``
around each call that ``spans.json`` names (a module attribute, or a
class attribute as ``Class.method``), installed when the traced run
starts and removed after it; the drivers open the ``orchestration`` span
around each entry call themselves. A target the program no longer has is
skipped, and the metrics of its layer read nothing.

A kernel belongs to the spans whose host interval, on the launching
thread, holds its launch: the runtime's launch event (a kernel's, or a
CUDA graph's for each kernel of the graph) and the kernel share a
correlation id.

The program's own ranges (``pano.<name>``, opened by the port's
``timer.span``) are kept apart from the layer spans, as ``program``
(name, start, end, thread), so that nothing that reads the layer spans
changes with them. A reader takes from them a count (``program_count``:
the outermost ranges of a name), a host time (``program_span_us``) and
the device time of the kernels launched inside them
(``program_kernel_us``), the arithmetic of the port's
``tools/torch_trace_summary.program_steps``.

The device's busy time is the union of its kernel, memcpy and memset
intervals over all its streams (copied from the port's
``tools/torch_trace_summary.py``), clipped to the traced window.
"""

from __future__ import annotations

import contextlib
import importlib
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

PREFIX = "pano_bench."
WINDOW = PREFIX + "window"
PROGRAM_PREFIX = "pano."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# A graph's launch is one launch: its kernels carry its correlation id,
# so they belong to the spans that hold it.
LAUNCH_NAMES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
    "cuGraphLaunch",
))


# --- spans -------------------------------------------------------------------


def _resolve(target: str):
    """(owner, attribute name) of "module:attr" or "module:Class.attr"."""
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


@contextlib.contextmanager
def wrapped(targets: Iterable[Tuple[str, object]]):
    """Replace each (target, make) of `targets`: the attribute becomes
    ``make(real)`` until the block ends. Targets that are missing are
    skipped."""
    done = []
    try:
        for target, make in targets:
            try:
                owner, attr = _resolve(target)
                real = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
            except (ImportError, AttributeError, KeyError):
                continue
            setattr(owner, attr, make(real))
            done.append((owner, attr, real))
        yield
    finally:
        for owner, attr, real in reversed(done):
            setattr(owner, attr, real)


def span_maker(layer: str):
    """A wrapper factory that puts a layer span around each call."""
    import torch

    name = PREFIX + layer

    def make(real):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return real(*args, **kwargs)
        return call
    return make


def layer_spans(entries: Sequence[dict]):
    """``wrapped``'s targets from ``spans.json``'s entries."""
    return [(e["target"], span_maker(e["layer"])) for e in entries]


# --- interval arithmetic -----------------------------------------------------


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(spans) -> float:
    return sum(e - s for s, e in union(spans))


def clip(spans, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in spans
            if min(e, hi) > max(s, lo)]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float):
    """The idle (start, end) intervals of [lo, hi] between `busy`'s
    disjoint sorted intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between the closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def kernel_base(name: str) -> str:
    """The bare identifier of a kernel's demangled name: "void
    (anonymous namespace)::match_kernel<4>(unsigned char const*, ...)"
    -> "match_kernel"; a copy or a set keeps its kind ("Memcpy HtoD")."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    bare, depth = [], 0
    for ch in name.replace("(anonymous namespace)", "anonymous"):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            bare.append(ch)
    head = "".join(bare).split("(", 1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


# --- the trace ---------------------------------------------------------------


class Trace:
    """A Chrome trace of one traced window, read for the metrics.

    `counts` are the harness's own counts of the window's work
    (panoramas, estimates, images), and `work` the roofline steps'
    bounds (``roofline.py``). Times are in microseconds, as the trace
    gives them; the readers turn them into their units. `timed` holds
    the host-clock numbers of the untraced run's window where the traced
    run made one first (``run.run_cell``), else nothing."""

    def __init__(self, trace: dict, counts: Dict[str, int],
                 work: Dict[str, float], kernel_steps: Dict[str, list],
                 devices: Sequence[int]):
        self.counts = counts
        self.work = work
        self.timed: Dict[str, float] = {}
        self.devices = list(devices)
        self.step_of = {k: step for step, names in kernel_steps.items()
                        for k in names}
        events = trace.get("traceEvents", trace) \
            if isinstance(trace, dict) else trace
        self.spans: List[tuple] = []     # (layer, start, end, tid)
        self.program: List[tuple] = []   # (name, start, end, tid)
        self.window: Optional[Tuple[float, float]] = None
        self.launches: List[tuple] = []  # (ts, correlation, tid)
        self.device: List[dict] = []
        self.cpu_ops: List[tuple] = []   # (start, end, name, tid)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat"), e.get("name", "")
            ts, dur = float(e["ts"]), float(e["dur"])
            if cat == "user_annotation" and name.startswith(PREFIX):
                if name == WINDOW:
                    self.window = (ts, ts + dur)
                else:
                    self.spans.append((name[len(PREFIX):], ts, ts + dur,
                                       e.get("tid")))
            elif cat == "user_annotation" \
                    and name.startswith(PROGRAM_PREFIX):
                self.program.append((name[len(PROGRAM_PREFIX):], ts,
                                     ts + dur, e.get("tid")))
            elif cat in ("cuda_runtime", "cuda_driver") \
                    and name in LAUNCH_NAMES:
                self.launches.append((ts, (e.get("args") or {}).get(
                    "correlation"), e.get("tid")))
            elif cat in DEVICE_CATS:
                args = e.get("args") or {}
                self.device.append({
                    "cat": cat, "name": name, "base": kernel_base(name),
                    "start": ts, "end": ts + dur,
                    "dev": args.get("device", e.get("pid")),
                    "corr": args.get("correlation"),
                })
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, name, e.get("tid")))
        if self.window is None:
            raise ValueError("trace has no " + WINDOW + " span")
        lo, hi = self.window
        self.spans = [s for s in self.spans if s[2] > lo and s[1] < hi]
        self.program = [s for s in self.program if s[2] > lo and s[1] < hi]
        self.device = [d for d in self.device
                       if d["end"] > lo and d["start"] < hi]
        self.launch_layers = self._attribute(self.launches, self.spans)
        by_corr = {c: layers for (ts, c, tid), layers
                   in zip(self.launches, self.launch_layers) if c is not None}
        in_program = {c: names for (ts, c, tid), names
                      in zip(self.launches,
                             self._attribute(self.launches, self.program))
                      if c is not None}
        for d in self.device:
            d["layers"] = by_corr.get(d["corr"], frozenset())
            d["program"] = in_program.get(d["corr"], frozenset())

    @staticmethod
    def _attribute(launches, spans) -> List[frozenset]:
        """The names of the `spans` ((name, start, end, tid)) that, on
        the launch's thread, hold each launch."""
        sweep: Dict[object, list] = defaultdict(list)
        for layer, s, e, tid in spans:
            sweep[tid] += [(s, 0, layer), (e, 2, layer)]
        for i, (ts, _, tid) in enumerate(launches):
            sweep[tid].append((ts, 1, i))
        out: List[frozenset] = [frozenset()] * len(launches)
        for marks in sweep.values():
            active: Dict[str, int] = defaultdict(int)
            for _, kind, what in sorted(marks, key=lambda m: m[:2]):
                if kind == 0:
                    active[what] += 1
                elif kind == 2:
                    active[what] -= 1
                else:
                    out[what] = frozenset(k for k, n in active.items() if n)
        return out

    # --- helpers for the readers --------------------------------------------

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def layer_spans(self, layer: str) -> List[Tuple[float, float, object]]:
        return [(s, e, tid) for name, s, e, tid in self.spans
                if name == layer]

    def on_device(self, layer: str) -> bool:
        """Whether a device metric of `layer` has something to read: the
        device was traced and the layer's spans are in the window. Its
        reading is then 0 where no work ran under them."""
        return bool(self.device) and bool(self.layer_spans(layer))

    def outermost(self, layer: str) -> List[Tuple[float, float, object]]:
        """`layer`'s spans not nested in another span of that layer."""
        out = []
        for s, e, tid in sorted(self.layer_spans(layer),
                                key=lambda x: (x[0], -x[1])):
            if out and out[-1][2] == tid and s < out[-1][1]:
                continue
            out.append((s, e, tid))
        return out

    def self_us(self, layer: str) -> float:
        """The outermost `layer` spans' host time minus what the other
        layers' spans inside them cover."""
        total = 0.0
        for s, e, tid in self.outermost(layer):
            inner = [(max(a, s), min(b, e)) for name, a, b, t in self.spans
                     if name != layer and t == tid and b > s and a < e]
            total += (e - s) - union_length(inner)
        return total

    def span_us(self, layer: str) -> float:
        return sum(e - s for s, e, _ in self.outermost(layer))

    def launches_in(self, layer: str) -> int:
        return sum(1 for layers in self.launch_layers if layer in layers)

    def program_spans(self, name: str) -> List[Tuple[float, float, object]]:
        """The program's ``pano.<name>`` ranges in the window, as (start,
        end, tid)."""
        return [(s, e, tid) for n, s, e, tid in self.program if n == name]

    def program_outermost(self, name: str
                          ) -> List[Tuple[float, float, object]]:
        """`name`'s ranges not nested in another of that name on the
        same thread."""
        last: Dict[object, float] = {}
        out = []
        for s, e, tid in sorted(self.program_spans(name),
                                key=lambda x: (x[0], -x[1])):
            if tid in last and s < last[tid]:
                continue
            last[tid] = e
            out.append((s, e, tid))
        return out

    def program_count(self, name: str) -> int:
        """How many times the program entered step `name`: its outermost
        ranges (a counter, such as the host's waits)."""
        return len(self.program_outermost(name))

    def program_span_us(self, name: str) -> float:
        """Host time in `name`'s outermost ranges."""
        return sum(e - s for s, e, _ in self.program_outermost(name))

    def program_kernel_us(self, name: str) -> float:
        """Device time of the kernels launched inside a ``pano.<name>``
        range on the launching thread, clipped to the window."""
        lo, hi = self.window
        return sum(min(d["end"], hi) - max(d["start"], lo)
                   for d in self.device
                   if d["cat"] == "kernel" and name in d["program"])

    def kernel_us(self, layer: Optional[str] = None) -> float:
        """Device time of the kernels launched under `layer` (all
        kernels when None), clipped to the window."""
        lo, hi = self.window
        return sum(min(d["end"], hi) - max(d["start"], lo)
                   for d in self.device
                   if d["cat"] == "kernel"
                   and (layer is None or layer in d["layers"]))

    def memcpy_us(self, kinds=("HtoD", "DtoH")) -> float:
        lo, hi = self.window
        return sum(min(d["end"], hi) - max(d["start"], lo)
                   for d in self.device if d["cat"] == "gpu_memcpy"
                   and any(k in d["name"] for k in kinds))

    def step_kernel_us(self) -> Dict[str, float]:
        """Device time of the kernels of each roofline step."""
        out: Dict[str, float] = defaultdict(float)
        lo, hi = self.window
        for d in self.device:
            step = self.step_of.get(d["base"]) if d["cat"] == "kernel" \
                else None
            if step is not None:
                out[step] += min(d["end"], hi) - max(d["start"], lo)
        return dict(out)

    def busy(self, dev) -> List[Tuple[float, float]]:
        """Device `dev`'s busy intervals (the union), within the window."""
        lo, hi = self.window
        return union(clip([(d["start"], d["end"]) for d in self.device
                           if d["dev"] == dev], lo, hi))

    def busy_us(self, dev) -> float:
        return sum(e - s for s, e in self.busy(dev))

    def overlap_us(self, at_least: int = 2) -> float:
        """Time in the window in which `at_least` devices are busy."""
        edges = []
        for dev in self.devices:
            for s, e in self.busy(dev):
                edges += [(s, 1), (e, -1)]
        edges.sort()
        total, level, last = 0.0, 0, None
        for t, step in edges:
            if level >= at_least and last is not None:
                total += t - last
            level += step
            last = t
        return total

    def host_label(self, t: float) -> str:
        """What the host was doing at `t`: the innermost layer span and
        the innermost torch operation that hold it."""
        inner = [(e - s, layer) for layer, s, e, _ in self.spans
                 if s <= t <= e]
        ops = [(e - s, name) for s, e, name, _ in self.cpu_ops
               if s <= t <= e]
        layer = min(inner)[1] if inner else "outside spans"
        return layer + (" / " + min(ops)[1] if ops else "")

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps (seconds), each labelled by what the host was doing."""
        by_name: Dict[str, float] = defaultdict(float)
        lo, hi = self.window
        for d in self.device:
            by_name[d["base"]] += min(d["end"], hi) - max(d["start"], lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = []
        for dev in self.devices:
            for s, e in gaps(self.busy(dev), lo, hi):
                idle.append((e - s, s, dev))
        idle.sort(reverse=True)
        return {
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[f"cuda:{dev} " + self.host_label((s + s + g) / 2),
                           g / 1e6] for g, s, dev in idle[:top]],
        }


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)
