"""Cells shrunk for the CPU: small images, fewer keypoints and
hypotheses, two scenes (eight for the batched cell); every kernel runs
its plain PyTorch version. Each cell takes its shrunk config and
traffic from ``shrunk/<cell>.json``, so that a cell is added by files
alone."""

import json
import pathlib

import torch

SEED = 2 ** 31 + 977   # more than 32 signed bits hold

# Cells whose traffic and drivers are here, but that BENCHMARK.json
# leaves out (PERF.md section 7): the mesh cell, whose runs spread too
# widely on a shared host for the largest bound; and the rotating pair,
# a rehearsal of a rotating camera's configuration to come, run under
# the 4K pair's configuration and limits, which were set on translations.
READY = [
    {"name": "pair4k.batch4_mesh4", "config": "mountain_pair_4k",
     "traffic": "batch4_mesh4", "chips": 4},
    {"name": "pair4k.rotate_pair", "config": "mountain_pair_4k",
     "traffic": "rotate_pair", "chips": 1},
]
# Of READY, the cells whose correctness at the CPU size is recorded, not
# asserted (``test_scene_models``).
REHEARSALS = ["pair4k.rotate_pair"]


def overrides(name: str, bench_dir=None) -> dict:
    """{"config": ..., "traffic": ...} that shrink cell `name`:
    ``tests/shrunk/<name>.json`` under `bench_dir` (this folder's
    benchmark by default)."""
    here = pathlib.Path(bench_dir) / "tests" if bench_dir is not None \
        else pathlib.Path(__file__).resolve().parent
    with open(here / "shrunk" / f"{name}.json") as f:
        return json.load(f)


def cpu_devices(cell: dict):
    return [torch.device("cpu")] * int(cell["chips"])
