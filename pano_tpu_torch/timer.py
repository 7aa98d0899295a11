"""Stage timing with the reference's machine-readable stdout contract.

Counterpart of ``pano_tpu/timer.py``'s timing half. Every stage prints
``"<Stage Name>: x.xxx ms"`` to stdout, three decimals, as the reference's
Timer does (src/serial/main.cpp:43-58); benchmark scripts grep those exact
strings, so the format is an API, not logging.

CUDA work is asynchronous: a stage that launched kernels synchronizes its
device before the clock stops (``synchronize``), where the JAX package
called ``force_sync``. On the CPU there is nothing to wait for.

The JAX module's ``stage`` context, ``STAGE_RECORDS`` and
``reset_stage_records`` serve its CLI's ``--json`` output; they come with
the CLI's port.
"""

from __future__ import annotations

import time

import torch


def synchronize(device) -> None:
    """Wait for every kernel queued on `device` (a no-op off the GPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock ms timer (reference Timer, src/serial/main.cpp:43-58)."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return (time.perf_counter() - self._start) * 1e3


def print_stage(name: str, ms: float) -> None:
    # Exact reference format: fixed, 3 decimals (src/serial/main.cpp:183).
    print(f"{name}: {ms:.3f} ms", flush=True)
