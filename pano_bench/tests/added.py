"""The files that a later change adds for a cell with a loop of its own,
written into a copy of this folder: a configuration, its limits, a
traffic file that names ``loops/auto_serial.py`` with ``"pairs": "all"``,
the cell's CPU sizes under ``tests/shrunk/``, and the BENCHMARK.json
entries. Nothing that is there is changed."""

import json
import pathlib
import shutil

from pano_bench.spec import HERE
from pano_bench.tests.small import overrides

# Unordered captures at the oilseed set's image size: a row of three,
# whose middle image (image 1) overlaps both others, and a 2x2 grid.
# Full size in the traffic file, shrunk for the CPU.
SHAPES = {
    "row3": ([[0, 0], [1245, 7], [2490, 19]],
             [[[0, 0], [83, 5], [171, 9]], [[0, 0], [79, 3], [165, 12]]]),
    "grid2x2": ([[0, 0], [1245, 7], [3, 1000], [1250, 1004]],
                [[[0, 0], [85, 3], [4, 70], [88, 74]],
                 [[0, 0], [81, 6], [2, 73], [84, 77]]]),
}


def copy_bench(tmp_path: pathlib.Path) -> pathlib.Path:
    """A copy of this folder and of BENCHMARK.json under `tmp_path`."""
    bench_dir = tmp_path / "pano_bench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    return bench_dir


def snapshot(bench_dir: pathlib.Path) -> dict:
    return {p.relative_to(bench_dir): p.read_bytes()
            for p in bench_dir.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def add_auto_cell(bench_dir: pathlib.Path, shape: str) -> str:
    """Add the cell ``auto.<shape>`` by new files and new entries of the
    copy's BENCHMARK.json (beside `bench_dir`); returns its name."""
    full, small = SHAPES[shape]
    config = f"oilseed_auto_{shape}"
    cfg = json.loads((bench_dir / "configs" /
                      "oilseed_chain_multiband.json").read_text())
    cfg.update(name=config, images_per_panorama=len(full))
    _write(bench_dir / "configs" / f"{config}.json", cfg)
    shutil.copy(bench_dir / "limits" / "oilseed_chain_multiband.json",
                bench_dir / "limits" / f"{config}.json")
    _write(bench_dir / "traffic" / f"auto_{shape}.json", {
        "driver": "auto_serial", "resident": "host", "pairs": "all",
        "scenes": [full, full], "sample_cycles": 1, "trace_panoramas": 2,
        "why": f"one caller, one unordered {shape} at a time through "
               "stitch_all_images(mode='auto')"})
    cell = f"auto.{shape}"
    chain = overrides("oilseed_chain.host_serial", bench_dir)["config"]
    _write(bench_dir / "tests" / "shrunk" / f"{cell}.json", {
        "config": chain, "traffic": {"scenes": small}})
    path = bench_dir.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({
        "name": config, "source": cfg["source"],
        "file": f"pano_bench/configs/{config}.json", "reduced": [],
        "why": f"an unordered {shape} of oilseed-sized images"})
    bench["workloads"].append({
        "name": cell, "config": config, "traffic": f"auto_{shape}",
        "chips": 1, "why": f"one caller, unordered {shape}, auto mode"})
    for metric in bench["end_to_end"]:
        if "workloads" in metric:       # the rate and the tail, as auto's
            metric["workloads"].append(cell)
    path.write_text(json.dumps(bench))
    return cell


def _write(path: pathlib.Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))
