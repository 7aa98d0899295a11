"""Finding a cell's parts by name: ``BENCHMARK.json`` and the data files,
metric readers, loops and scene models under this folder.

A later change adds a cell, a traffic mix, a configuration, a metric or
a scene model by adding files here and entries to ``BENCHMARK.json``;
nothing in this module names one of them but the scene model of a
traffic file that names none (``DEFAULT_SCENE``).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
# The scene model of a traffic file without a "scene" key: crops of one
# texture at the offsets the traffic lists.
DEFAULT_SCENE = "crops"


class Spec:
    """``BENCHMARK.json`` and the files beside it, rooted at `bench_dir`
    (this folder by default) and `repo` (its parent)."""

    def __init__(self, bench_dir: pathlib.Path = HERE,
                 benchmark_json: Optional[pathlib.Path] = None):
        self.dir = pathlib.Path(bench_dir)
        self.repo = self.dir.parent
        path = benchmark_json or self.repo / "BENCHMARK.json"
        with open(path) as f:
            self.bench = json.load(f)
        self._readers: Dict[str, Callable] = {}
        self._loops: Dict[str, ModuleType] = {}
        self._scene_models: Dict[str, ModuleType] = {}

    def _load_json(self, path: pathlib.Path) -> dict:
        with open(path) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration file of `name` as it is run."""
        for c in self.bench["configs"]:
            if c["name"] == name:
                return self._load_json(self.repo / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._load_json(self.dir / "traffic" / f"{name}.json")

    def limits(self, config_name: str) -> dict:
        return self._load_json(self.dir / "limits" / f"{config_name}.json")

    def data(self, name: str):
        """A data file of the harness itself (``kernel_steps.json``,
        ``spans.json``)."""
        return self._load_json(self.dir / name)

    def metrics(self, cell: str, kind: str) -> List[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it under "workloads", or list none."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str) -> Callable:
        """``read(trace)`` of ``metrics/<metric>.py``."""
        if metric not in self._readers:
            self._readers[metric] = _load(
                self.dir / "metrics" / f"{metric}.py",
                f"pano_bench_metric_{len(self._readers)}").read
        return self._readers[metric]

    def loop(self, name: str) -> ModuleType:
        """The module of ``loops/<name>.py``: a loop that a traffic file
        names as its "driver" and ``drivers.DRIVERS`` does not hold
        (``drivers.loop_of``)."""
        if name not in self._loops:
            self._loops[name] = _load(self.dir / "loops" / f"{name}.py",
                                      f"pano_bench_loop_{len(self._loops)}")
        return self._loops[name]

    def scene_model(self, name: str) -> ModuleType:
        """The module of ``scene_models/<name>.py``: how the scenes of a
        traffic file that names it as its "scene" are made (its
        ``make_pool``)."""
        if name not in self._scene_models:
            self._scene_models[name] = _load(
                self.dir / "scene_models" / f"{name}.py",
                f"pano_bench_scene_{len(self._scene_models)}")
        return self._scene_models[name]

    def pool(self, traffic: dict, cfg: dict, seed: int, device) -> list:
        """The pool of a cell with this traffic and configuration: its
        scene model's ``make_pool`` (``DEFAULT_SCENE`` where the traffic
        names none), made from `seed` on `device`, held as the traffic's
        "resident" says."""
        model = self.scene_model(traffic.get("scene", DEFAULT_SCENE))
        return model.make_pool(traffic, cfg, seed, device,
                               traffic["resident"])


def _load(path: pathlib.Path, module_name: str) -> ModuleType:
    """The Python file at `path`, run as a module of its own."""
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    if mod_spec is None or mod_spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
