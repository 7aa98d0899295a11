"""Run one cell of the benchmark once, on this machine's CUDA devices.

    python3 -m pano_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from this module's import): import
torch and the port, make the cell's pool of planted scenes from
the seed on the first card (by the traffic's scene model, ``"scene"``:
a file ``scene_models/<scene>.py``, crops at offsets where it names
none), and drive the whole pool once through the
cell's loop, which builds the kernels in a checkout's first run
(``build/pano_tpu_torch/``, inside the checkout) and makes every shape
and table the traffic uses.

``--trace 0``: the window. Peak-memory statistics are reset on every
card of the cell, requests are issued for ``--seconds`` seconds, and
what is in flight then is drained; the window ends when the last
panorama is ready. It reports the cell's end-to-end metrics.

``--trace 1``: ``trace_panoramas`` panoramas through the same loop under
``torch.profiler``, the loop drained before and after, with the layer
spans of ``spans.json`` installed. It reports the cell's per-layer
metrics, read by ``metrics/<name>.py`` from the trace, and the
breakdown. Where one of those metrics is taken on the host's clock
(``window.*``: the rate and the tail of a cell whose runs spread too
widely for an end-to-end bound), the window of ``--trace 0`` runs
first, untraced and as it is there, and its numbers are handed to the
readers with the trace (``Trace.timed``).

The traffic file names the loop ("driver": a loop of ``drivers.py``,
or a file ``loops/<driver>.py``) and may say which pairs a panorama
estimates ("pairs": "adjacent", the default, n - 1 a panorama of n
images; "all", n(n - 1)/2, as an unordered set is matched), which sets
the estimates that the per-layer metrics count and the roofline's match
and eigenvector work.

Either way, once the loop has ended, the peak memory has been read and
the program's state is freed, the answers are held against the plain
reference (``reference.py``): every panorama's placement, and the
panoramas sampled from the seed (each scene's at an occurrence drawn
from [0, ``sample_cycles``); in a traced run without the window, from
the panoramas that the loop makes right after the traced ones, so that
the sample's copies stay out of the trace). The numbers compared are
printed, each with its limit, as the last lines of standard error and
under "compared", the last key of the result line, the last line of
standard output.

Without a CUDA device, or with fewer than the cell asks for, it prints
why on standard error and exits 2, with no result. If the process holds
JAX or the JAX package once the window has closed (``jax_modules``), it
names them on standard error and exits 3, with no result.
"""

from __future__ import annotations

import time

# setup_s counts from here: the imports below load torch and the port.
T_IMPORT = time.perf_counter()

import argparse
import contextlib
import copy
import gc
import json
import os
import random
import subprocess
import sys
import tempfile
from typing import List, Optional, Sequence

from pano_bench import drivers, reference, roofline, scenes  # noqa: E402
from pano_bench import trace as tracing  # noqa: E402
from pano_bench.spec import Spec  # noqa: E402


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pano_config(options: dict):
    """The port's PanoConfig from a configuration file's
    "pano_config" (fields left out keep their defaults)."""
    from pano_tpu_torch.config import (HarrisOptions, PanoConfig,
                                       RansacOptions, StitchOptions)

    return PanoConfig(harris=HarrisOptions(**options.get("harris", {})),
                      ransac=RansacOptions(**options.get("ransac", {})),
                      stitch=StitchOptions(**options.get("stitch", {})))


def merged(base: dict, over: Optional[dict]) -> dict:
    """`base` with `over`'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) \
            and isinstance(out.get(k), dict) else v
    return out


def make_sample(seed: int, pool, cfg: dict, cycles: int, pinned: bool):
    """Each scene's occurrence to keep, drawn from the seed in [0,
    `cycles`), with room for its planted panorama (``reference.canvas``,
    in image 0's frame) and a pixel more each way."""
    rng = random.Random(f"sample:{seed}")
    sizes = {}
    for k, scene in enumerate(pool):
        ch, cw = reference.canvas(reference.shapes(scene.images),
                                  scenes.planted_globals(scene))
        sizes[k] = (ch + 2) * (cw + 2) * 3
    return drivers.Sample({k: rng.randrange(cycles) for k in sizes}, sizes,
                          pinned)


def _peak_bytes(devices) -> int:
    import torch
    return max([torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"] + [0])


def _reset_peaks(devices) -> None:
    import torch
    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.reset_peak_memory_stats(d)


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def window_work(answers: List[dict], cfg: dict, pool, alpha: bool,
                pairs: str = "adjacent") -> dict:
    """The roofline steps' least seconds summed over the answers, each
    panorama's drawn in its anchor's frame on the planted canvas."""
    work: dict = {}
    harris = cfg["pano_config"].get("harris", {})
    k = harris.get("max_keypoints", 8192)
    p = harris.get("patch_size", 5)
    for a in answers:
        scene, anchor = pool[a["scene"]], a.get("anchor", 0)
        hw = reference.shapes(scene.images)
        frame = reference.in_frame(scenes.planted_globals(scene), anchor)
        steps = roofline.panorama_steps(hw, reference.canvas(hw, frame), k,
                                        p, alpha, pairs, frame, anchor)
        for s, v in steps.items():
            work[s] = work.get(s, 0.0) + v
    return work


def run_cell(spec: Spec, cell: dict, seed: int, seconds: float, trace: bool,
             devices, t_start: float, overrides: Optional[dict] = None
             ) -> dict:
    """One run of `cell` on `devices` (torch devices; the first holds the
    pool): the result line's object. `overrides` ({"config": ...,
    "traffic": ...}) shrink a cell for the CPU rehearsal tests."""
    import torch

    overrides = overrides or {}
    cfg = merged(spec.config(cell["config"]), overrides.get("config"))
    traffic = merged(spec.traffic(cell["traffic"]), overrides.get("traffic"))
    limits = spec.limits(cell["config"])
    pool = spec.pool(traffic, cfg, seed, devices[0])
    pairs = traffic.get("pairs", "adjacent")
    make, found = drivers.loop_of(traffic["driver"], spec)
    run = drivers.Run(pano_config(cfg["pano_config"]), traffic, pool,
                      devices)
    cuda = devices[0].type == "cuda"
    sample = make_sample(seed, pool, cfg, int(traffic["sample_cycles"]),
                         cuda)
    n_pool = len(pool)
    per_layer = spec.metrics(cell["name"], "per_layer")
    timed = not trace or any(m["source"] == "host_clock" for m in per_layer)
    with drivers.captures(traffic["driver"], run, found), \
            contextlib.redirect_stdout(drivers.Silent()):
        loop = make(run)
        loop(drivers.count(n_pool), drivers.NO_SAMPLE)
        run.sync()
        setup_s = time.perf_counter() - t_start
        _reset_peaks(devices)
        answers = []
        if timed:
            t_open = time.perf_counter()
            answers = loop(drivers.until(t_open + seconds), sample)
            run.sync()
            window_s = max(a["t1"] for a in answers) - t_open
        n_window = len(answers)
        if trace:
            traced_answers, t = traced(spec, run, loop,
                                       int(traffic["trace_panoramas"]),
                                       devices, getattr(found, "SPANS", []))
            answers = answers + traced_answers
        peak = _peak_bytes(devices)
        if trace and not timed:
            # The pixel sample comes from the panoramas that the same
            # loop makes next, so that its copies stay out of the trace.
            answers = answers + loop(drivers.count(
                n_pool * int(traffic["sample_cycles"])), sample)
            run.sync()
    del loop, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    judged = reference.judge(answers, pool, limits)
    ok = judged["failed"] == 0 and bool(answers) \
        and reference.within(judged["compared"])
    window = {}
    if timed:
        failed = sum(i < n_window for i in judged["failed_at"])
        window = {
            "panoramas_per_s": (n_window - failed) / window_s,
            "latency_p95_ms": tracing.percentile(
                [(a["t1"] - a["t0"]) * 1e3 for a in answers[:n_window]], 95),
        }
    device = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
        "count": len({str(d) for d in devices}) if cuda else len(devices),
        "memory_peak_bytes": peak,
        "power_limit": card_limit() if cuda else "none",
    }
    if not trace:
        values = dict(window, peak_mem_mib=peak / 2 ** 20, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics(cell["name"], "end_to_end")
                   if m["name"] in values}
    else:
        work = window_work(traced_answers, cfg, pool,
                           cfg["pano_config"].get("stitch", {}).get(
                               "blend", "overlay") != "overlay", pairs)
        n_img = len(pool[0].images)
        n = len(traced_answers)
        t.counts = {"panoramas": n,
                    "estimates": n * roofline.estimates(n_img, pairs),
                    "images": n * n_img}
        t.work = work
        t.timed = window
        metrics = {}
        for m in per_layer:
            v = spec.reader(m["name"])(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device["busy_s"] = sum(t.busy_us(d) for d in t.devices) \
            / max(len(t.devices), 1) / 1e6
        device["window_s"] = t.window_us / 1e6
    out = {"correct": ok, "attempted": len(answers),
           "failed": judged["failed"], "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = t.breakdown()
    out["compared"] = judged["compared"]   # last, as the contract asks
    return out


def traced(spec: Spec, run, loop, n: int, devices, spans=()):
    """`n` panoramas through `loop` under torch.profiler with the layer
    spans of ``spans.json`` and `spans` (a loop file's) installed, none
    of them kept; returns (answers, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    run.span = lambda layer: record_function(tracing.PREFIX + layer)
    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    with tracing.wrapped(tracing.layer_spans(spec.data("spans.json")
                                             + list(spans))):
        run.sync()
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                answers = loop(drivers.count(n), drivers.NO_SAMPLE)
                run.sync()
    run.span = lambda layer: contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        raw = tracing.load(path)
    cards = sorted({d.index or 0 for d in devices if d.type == "cuda"})
    t = tracing.Trace(raw, {}, {}, spec.data("kernel_steps.json"), cards)
    return answers, t


# Top-level modules that the port's run may not load: JAX and the JAX
# package this repository ports (a whole top-level name: the port's
# package is "pano_tpu_torch").
JAX_MODULES = frozenset(("jax", "jaxlib", "flax", "pano_tpu"))


def jax_modules(modules=None) -> List[str]:
    """The top-level names of `modules` (sys.modules' names by default)
    that are JAX or the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & JAX_MODULES)


def main(argv: Optional[Sequence[str]] = None) -> int:
    t_start = T_IMPORT
    args = parse_args(argv)
    spec = Spec()
    cell = spec.workload(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"pano_bench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s), found {found}; no result", file=sys.stderr)
        return 2
    # One intra-op thread: the host side of these cells is Python and
    # small numpy work, and a pool of spinning threads only adds noise.
    torch.set_num_threads(1)
    devices = [torch.device("cuda", i) for i in range(int(cell["chips"]))]
    out = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   devices, t_start)
    loaded = jax_modules()
    if loaded:
        print(f"pano_bench: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
