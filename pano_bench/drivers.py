"""The general loops that drive the program; a traffic file picks one by
its "driver" and sets its parameters.

Every loop is closed: one caller, which issues its next request when
the loop allows (one at a time, or ``depth`` in flight). Request i takes
the pool's scene i mod P (a batch takes B scenes in a row), so every
scene comes round in turn. A loop runs until ``stop(n)`` says so, n
being the panoramas issued so far, then drains what is in flight.

Each panorama gives an answer: the scene, the homographies it was
placed with (None when it came back empty), a host copy of the panorama
when the ``Sample`` wants it (taken after its latency was read), and the
time its request was issued and the time it was ready for the caller:
synchronized on the card where the caller keeps it there, back on the
host where the entry returns numpy.

* ``pair_serial``: ``PairStitcher.stitch_pair_fast`` on each pair, the
  panorama kept on the card.
* ``pair_pipelined``: the library's ``dispatch`` / ``retire`` with
  ``depth`` pairs in flight (the loop of the port's
  ``benchmark_throughput_torch.pipelined``), each panorama fetched by
  ``timer.fetch_image`` and dropped.
* ``chain_serial``: ``pipeline.stitch_all_images_chain`` on each scene's
  images, the panorama returned as host numpy.
* ``pair_batched``: ``parallel/shard.py``'s ``stitch_pairs_batched`` on
  batches of ``batch`` pairs over a ``make_mesh(*mesh)`` of the cell's
  devices.

A loop that ``DRIVERS`` does not hold is a file of its own,
``loops/<driver>.py`` (``loop_of``), so that a cell with a loop of its
own is added by files alone. The file defines ``make(run)``, which
returns the loop as a ``DRIVERS`` entry does, and may define
``capture(run)``, a context that records what each panorama was placed
with (built with ``trace.wrapped``, as ``_CAPTURES``' entries are), and
``SPANS``, layer spans of its own entry's calls in ``spans.json``'s
form, installed with those of ``spans.json`` in the traced run.

An answer's placement is each image's homography into image 0's frame.
Where the entry frames the panorama in another image's, the anchor, the
capture converts it (``inv(g_0) @ g_i``, all None when image 0 was left
out) and the answer carries the anchor (``_answer``'s `anchor`), which
the reference draws first and whose edges it does not band.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pano_bench.trace import wrapped

Stop = Callable[[int], bool]


class Run:
    """What a loop is given: the pipeline's config, the traffic, the
    pool, the cell's devices, and the span factory (a no-op outside the
    traced run)."""

    def __init__(self, pano_config, traffic: dict, pool, devices):
        self.config = pano_config
        self.traffic = traffic
        self.pool = pool
        self.devices = list(devices)
        self.span = lambda layer: contextlib.nullcontext()
        self.placed: List = []   # filled by the capture wrappers

    def sync(self) -> None:
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)


class Sample:
    """The panoramas kept for the check: each scene's at the occurrence
    `cycles` draws for it. A kept panorama is copied into storage made
    at set-up (`sizes`: each scene's largest panorama in bytes), so that
    keeping it costs the window one copy and no allocation: from the card
    by a non-blocking copy into page-locked memory (`pinned`), on the
    host by a copy into memory already touched."""

    def __init__(self, cycles: Dict[int, int], sizes: Dict[int, int],
                 pinned: bool):
        self.cycles = cycles
        self.store = {k: torch.zeros(n, dtype=torch.uint8, pin_memory=pinned)
                      for k, n in sizes.items() if k in cycles}

    def wants(self, scene: int, occurrence: int) -> bool:
        return self.cycles.get(scene) == occurrence

    def take(self, scene: int, pano):
        n = int(np.prod(pano.shape))
        buf = self.store.get(scene)
        if buf is None or n > buf.numel():    # larger than planted: rare
            return np.array(pano) if isinstance(pano, np.ndarray) \
                else pano.cpu()
        if isinstance(pano, np.ndarray):
            out = buf[:n].numpy().reshape(pano.shape)
            np.copyto(out, pano)
            return out
        out = buf[:n].view(pano.shape)
        out.copy_(pano, non_blocking=pano.device.type == "cuda")
        return out


NO_SAMPLE = Sample({}, {}, False)


def _answer(scene: int, occurrence: int, pano, placed, sample: Sample,
            t0: float, t1: float, anchor: int = 0) -> dict:
    kept = pano is not None and sample.wants(scene, occurrence)
    return {"scene": scene, "placed": placed if pano is not None else None,
            "pano": sample.take(scene, pano) if kept else None,
            "t0": t0, "t1": t1, "anchor": anchor}


def in_image0_frame(globals_h) -> List[Optional[np.ndarray]]:
    """Placements into another image's frame as placements into image
    0's: ``inv(g_0) @ g_i``, None for an image left out, all None when
    image 0 was left out."""
    if globals_h[0] is None:
        return [None] * len(globals_h)
    back = np.linalg.inv(np.asarray(globals_h[0], np.float64))
    return [None if g is None else back @ np.asarray(g, np.float64)
            for g in globals_h]


def _pair_placed(row) -> List[np.ndarray]:
    """[image 0's, image 1's] placement from a 14-float estimate row."""
    return [np.eye(3), np.asarray(row[:9], np.float64).reshape(3, 3)]


def _ready(pano) -> None:
    """Wait until a panorama the caller keeps on the card is there."""
    if isinstance(pano, torch.Tensor) and pano.device.type == "cuda":
        torch.cuda.synchronize(pano.device)


def pair_serial(run: Run):
    from pano_tpu_torch.pipeline import PairStitcher

    st = PairStitcher(run.config, print_timing=False, device=run.devices[0])
    p = len(run.pool)

    def loop(stop: Stop, sample: Sample) -> List[dict]:
        out, i = [], 0
        while not stop(i):
            k = i % p
            t0 = time.perf_counter()
            with run.span("orchestration"):
                pano = st.stitch_pair_fast(*run.pool[k].images)
            _ready(pano)
            t1 = time.perf_counter()
            out.append(_answer(k, i // p, pano,
                               _pair_placed(st.last_estimate), sample, t0,
                               t1))
            i += 1
        return out
    return loop


def pair_pipelined(run: Run):
    from pano_tpu_torch.pipeline import PairStitcher
    from pano_tpu_torch.timer import fetch_image

    st = PairStitcher(run.config, print_timing=False, device=run.devices[0])
    p = len(run.pool)
    depth = int(run.traffic["depth"])

    def loop(stop: Stop, sample: Sample) -> List[dict]:
        out, i = [], 0
        inflight: deque = deque()
        while True:
            if not stop(i):
                k = i % p
                t0 = time.perf_counter()
                with run.span("orchestration"):
                    pending = st.dispatch(*run.pool[k].images)
                inflight.append((k, i // p, t0, pending))
                i += 1
                if len(inflight) < depth:
                    continue
            if not inflight:
                return out
            k, occ, t0, pending = inflight.popleft()
            with run.span("orchestration"):
                pano = st.retire(pending)
            row = st.last_estimate
            with run.span("orchestration"):
                host = fetch_image(pano) if pano is not None else None
            t1 = time.perf_counter()
            out.append(_answer(k, occ, host, _pair_placed(row), sample,
                               t0, t1))
    return loop


def chain_serial(run: Run):
    from pano_tpu_torch import pipeline

    p = len(run.pool)
    dev = run.devices[0]

    def loop(stop: Stop, sample: Sample) -> List[dict]:
        out, i = [], 0
        while not stop(i):
            k = i % p
            run.placed.clear()
            t0 = time.perf_counter()
            with run.span("orchestration"):
                pano = pipeline.stitch_all_images_chain(
                    run.pool[k].images, run.config, False, "", dev)
            t1 = time.perf_counter()
            placed = run.placed[-1] if run.placed else None
            out.append(_answer(k, i // p, pano, placed, sample, t0, t1))
            i += 1
        return out
    return loop


def pair_batched(run: Run):
    from pano_tpu_torch.parallel import shard

    mesh = shard.make_mesh(*run.traffic["mesh"], devices=run.devices)
    b = int(run.traffic["batch"])
    p = len(run.pool)
    if p % b:
        raise ValueError(f"pool {p} is not a whole number of batches of {b}")
    stacks = [tuple(np.stack([run.pool[s].images[side]
                              for s in range(j * b, (j + 1) * b)])
                    for side in (0, 1)) for j in range(p // b)]

    def loop(stop: Stop, sample: Sample) -> List[dict]:
        out, i = [], 0
        while not stop(i):
            first = i % p
            lefts, rights = stacks[first // b]
            run.placed.clear()
            t0 = time.perf_counter()
            with run.span("orchestration"):
                panos = shard.stitch_pairs_batched(lefts, rights, run.config,
                                                   mesh)
            t1 = time.perf_counter()
            hs = run.placed[-1] if run.placed else None
            for j, pano in enumerate(panos):
                placed = None if hs is None or j >= len(hs) else \
                    [np.eye(3), np.asarray(hs[j], np.float64)]
                out.append(_answer(first + j, (i + j) // p, pano, placed,
                                   sample, t0, t1))
            i += b
        return out
    return loop


DRIVERS: Dict[str, Callable] = {
    "pair_serial": pair_serial,
    "pair_pipelined": pair_pipelined,
    "chain_serial": chain_serial,
    "pair_batched": pair_batched,
}


def _capture_globals(run: Run):
    """composite_global(images, devs, globals_h, ...): the placements."""
    def make(real):
        def call(images, devs, globals_h, *args, **kwargs):
            run.placed.append([None if g is None else np.asarray(g, np.float64)
                               for g in globals_h])
            return real(images, devs, globals_h, *args, **kwargs)
        return call
    return make


def _capture_batch(run: Run):
    """composite_pairs_batched(lefts, rights, hs, ok, ...): the
    placements of the batch's right images."""
    def make(real):
        def call(lefts, rights, hs, ok, *args, **kwargs):
            run.placed.append(np.asarray(hs, np.float64).copy())
            return real(lefts, rights, hs, ok, *args, **kwargs)
        return call
    return make


_CAPTURES = {
    "chain_serial": ("pano_tpu_torch.pipeline:composite_global",
                     _capture_globals),
    "pair_batched": ("pano_tpu_torch.parallel.shard:composite_pairs_batched",
                     _capture_batch),
}


def loop_of(driver: str, spec) -> Tuple[Callable, Optional[ModuleType]]:
    """(make, loop file): `driver`'s ``make(run)`` from ``DRIVERS``, with
    no loop file, else from ``spec.loop(driver)``, the module of
    ``loops/<driver>.py``."""
    if driver in DRIVERS:
        return DRIVERS[driver], None
    found = spec.loop(driver)
    return found.make, found


def captures(driver: str, run: Run, found: Optional[ModuleType] = None):
    """The wrappers that record what the driver's entry placed each
    panorama with, where the entry does not return it (a context): its
    ``_CAPTURES`` entry, else the ``capture`` of its loop file `found`,
    else none."""
    if driver in _CAPTURES:
        target, factory = _CAPTURES[driver]
        return wrapped([(target, factory(run))])
    if found is not None and hasattr(found, "capture"):
        return found.capture(run)
    return contextlib.nullcontext()


def count(n: int) -> Stop:
    return lambda issued: issued >= n


def until(deadline: float) -> Stop:
    return lambda issued: time.perf_counter() >= deadline


class Silent:
    """A stdout that drops what the entry prints ("Stitching image i of
    n...")."""

    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass
