"""BENCHMARK.json and the files it names: each found by name, each
within the benchmark's contract; and a cell, a traffic mix and a metric
added by files alone."""

import json
import re
import shutil
import time

import pytest
import torch

from pano_bench import drivers
from pano_bench.run import run_cell
from pano_bench.spec import DEFAULT_SCENE, HERE, Spec
from pano_bench.tests.added import add_auto_cell, snapshot
from pano_bench.tests.small import SEED, overrides

SPEC = Spec()
BENCH = SPEC.bench
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["pano_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    assert NAME.match(entry["name"])
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("pano_bench/")
    assert 1 <= len(entry["source"]) <= 200
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cfg = SPEC.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    limits = SPEC.limits(entry["name"])
    assert set(limits) >= {"h_err_px", "canvas_px", "pixel_max_d"}
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_and_traffic_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    traffic = SPEC.traffic(cell["traffic"])
    assert callable(drivers.loop_of(traffic["driver"], SPEC)[0])
    n_img = SPEC.config(cell["config"])["images_per_panorama"]
    assert all(len(s) == n_img for s in traffic["scenes"])
    assert traffic["trace_panoramas"] >= \
        len(traffic["scenes"]) * traffic["sample_cycles"]
    reported = [m["name"] for m in SPEC.metrics(cell["name"], "per_layer")]
    assert reported
    end_to_end = {m["name"] for m in SPEC.metrics(cell["name"], "end_to_end")}
    assert "setup_s" in end_to_end and len(end_to_end) >= 2
    assert all(m["moves"] in end_to_end
               for m in SPEC.metrics(cell["name"], "per_layer"))


def test_every_traffic_file_and_metric_reader_loads():
    """The ready cells' traffic and the mesh reader too, not only what
    BENCHMARK.json names."""
    for path in sorted((HERE / "traffic").glob("*.json")):
        traffic = SPEC.traffic(path.stem)
        assert callable(drivers.loop_of(traffic["driver"], SPEC)[0]), path
        assert traffic["resident"] in ("device", "host"), path
        model = SPEC.scene_model(traffic.get("scene", DEFAULT_SCENE))
        assert callable(model.make_pool), path
    for path in sorted((HERE / "metrics").glob("*.py")):
        assert callable(SPEC.reader(path.stem)), path


def test_every_loop_file_loads_and_makes_a_loop():
    paths = sorted((HERE / "loops").glob("*.py"))
    assert paths
    for path in paths:
        assert path.stem not in drivers.DRIVERS, path
        make, found = drivers.loop_of(path.stem, SPEC)
        assert callable(make) and found is SPEC.loop(path.stem), path
        assert not hasattr(found, "capture") or callable(found.capture)
        for entry in getattr(found, "SPANS", []):
            assert set(entry) == {"target", "layer"}, path


def test_every_scene_model_file_loads_and_crops_is_the_default():
    paths = sorted((HERE / "scene_models").glob("*.py"))
    assert DEFAULT_SCENE in [p.stem for p in paths]
    for path in paths:
        assert callable(SPEC.scene_model(path.stem).make_pool), path


def test_cells_are_distinct_and_four_chips_are_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    for w in metric.get("workloads", []):
        SPEC.workload(w)
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
        assert callable(SPEC.reader(metric["name"]))


def test_setup_s_is_an_end_to_end_metric():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    """A copy of this folder with one more traffic file, one more metric
    reader and the BENCHMARK.json entries for them: the new cell runs
    and reports the new metric. Then a cell with a loop of its own
    (``loops/auto_serial.py``), added as the next configuration would
    be: a configuration, limits, a traffic file with "pairs": "all", its
    CPU sizes under ``tests/shrunk/``, a reader of a range of the
    program, and the entries: it runs correct and reports the reader. No
    file that was there changed."""
    bench_dir = tmp_path / "pano_bench"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = snapshot(bench_dir)
    traffic = json.loads((bench_dir / "traffic" /
                          "device_serial.json").read_text())
    traffic["scenes"] = traffic["scenes"][:2]
    (bench_dir / "traffic" / "device_serial_two.json").write_text(
        json.dumps(traffic))
    (bench_dir / "metrics" / "detect.spans.py").write_text(
        "def read(t):\n    n = len(t.outermost('detect'))\n"
        "    return n or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "pair4k.device_serial_two", "config": "mountain_pair_4k",
        "traffic": "device_serial_two", "chips": 1, "why": "two pairs"})
    bench["per_layer"].append({
        "name": "detect.spans", "unit": "spans", "better": "lower",
        "source": "program_span", "layer": "detect",
        "moves": "panoramas_per_s", "workloads": ["pair4k.device_serial_two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(bench_dir)
    cell = spec.workload("pair4k.device_serial_two")
    over = overrides("pair4k.device_serial")
    over = {"config": over["config"],
            "traffic": {k: v for k, v in over["traffic"].items()
                        if k != "scenes"}}
    over["traffic"]["scenes"] = [[[0, 0], [83, 5]], [[0, 0], [97, 11]]]
    out = run_cell(spec, cell, SEED, 0.3, True, [torch.device("cpu")],
                   time.perf_counter(), over)
    assert out["correct"]
    assert out["metrics"]["detect.spans"]["value"] == 4   # 2 pairs x 2

    name = add_auto_cell(bench_dir, "row3")
    (bench_dir / "metrics" / "detect.calls.py").write_text(
        "def read(t):\n    n = t.program_count('detect')\n"
        "    return n / t.counts['images'] if n else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "detect.calls", "unit": "calls", "better": "lower",
        "source": "program_counter", "layer": "detect",
        "moves": "panoramas_per_s", "workloads": [name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(bench_dir)
    out = run_cell(spec, spec.workload(name), SEED, 0.3, True,
                   [torch.device("cpu")], time.perf_counter(),
                   overrides(name, bench_dir))
    assert out["correct"], out["compared"]
    assert out["metrics"]["detect.calls"]["value"] == 1   # once an image
    after = snapshot(bench_dir)
    assert all(after[k] == v for k, v in before.items())


def test_jax_modules_by_whole_top_level_name():
    from pano_bench.run import jax_modules
    assert jax_modules(["pano_tpu_torch", "pano_tpu_torch.ops.ransac",
                        "torch", "jaxtyping", "pano_bench"]) == []
    assert jax_modules(["jax.numpy", "jaxlib", "flax.linen", "pano_tpu.ops",
                        "torch"]) == ["flax", "jax", "jaxlib", "pano_tpu"]
