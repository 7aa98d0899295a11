"""Whole runs on the CPU at a small size (every kernel's plain
version), each cell traced and untraced; the control; and the faults
that a broken timed path can have, each of which must turn ``correct``
false. The command itself refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pano_bench import drivers
from pano_bench.control import control_run
from pano_bench.run import run_cell
from pano_bench.spec import HERE, Spec
from pano_bench.tests.small import READY, REHEARSALS, SEED, cpu_devices, \
    overrides

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.bench["workloads"]] + [c["name"]
                                                        for c in READY]
REPO = HERE.parent


def cell_of(name):
    ready = [c for c in READY if c["name"] == name]
    return ready[0] if ready else SPEC.workload(name)


# The cells whose loop estimates each pair through pipeline.estimate_row
# (the loops of drivers.DRIVERS); a cell with a loop file of its own
# plants its altered estimate in its own test (test_auto_cell.py).
ESTIMATE_ROW_CELLS = [n for n in CELLS if SPEC.traffic(
    cell_of(n)["traffic"])["driver"] in drivers.DRIVERS]


def run(name, trace=False, seconds=0.5):
    cell = cell_of(name)
    return run_cell(SPEC, cell, SEED, seconds, trace, cpu_devices(cell),
                    time.perf_counter(), overrides(name))


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", [n for n in CELLS if n not in REHEARSALS])
def test_cell_runs_and_is_correct(name, trace):
    out = run(name, trace)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["compared"]) == {"h_err_px", "canvas_px", "pixel_max_d",
                                    "missing"}
    if trace and name in [c["name"] for c in READY]:
        assert "breakdown" in out    # its metrics are not in BENCHMARK.json
    elif trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert "breakdown" in out
        # host spans and the host's clock read on the CPU; device
        # metrics read nothing there
        per_layer = {m["name"]: m for m in SPEC.metrics(name, "per_layer")}
        assert {n for n in per_layer if n == "ransac.host_ms"
                or per_layer[n]["source"] == "host_clock"} <= set(out["metrics"])
        assert "device.idle_pct" not in out["metrics"]
    elif name not in [c["name"] for c in READY]:
        assert set(out["metrics"]) == {
            m["name"] for m in SPEC.metrics(name, "end_to_end")}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    got = control_run(SPEC, cell_of(name), SEED, torch.device("cpu"),
                      overrides(name))
    assert not got["correct"], got


# --- faults of the timed path ------------------------------------------------


def left_only(self, left, right, m_inv, ty, tx, window, out_h, out_w):
    """The compose step returning its canvas unchanged: the base image
    placed, the warped one never written."""
    canvas = torch.zeros((out_h, out_w, 3), dtype=torch.uint8,
                         device=left.device)
    canvas[ty:ty + left.shape[0], tx:tx + left.shape[1]] = left
    return canvas


def shifted_estimate(monkeypatch):
    """An answer altered where it is produced: the estimate row's x
    translation off by 2 px."""
    from pano_tpu_torch import pipeline
    real = pipeline.estimate_row

    def est(*args, **kwargs):
        row, pts = real(*args, **kwargs)
        return row + torch.nn.functional.one_hot(
            torch.tensor(2), row.shape[0]).to(row) * 2.0, pts
    monkeypatch.setattr(pipeline, "estimate_row", est)


def test_pair_compose_left_unchanged(monkeypatch):
    from pano_tpu_torch import pipeline
    monkeypatch.setattr(pipeline.PairStitcher, "_compose", left_only)
    for name in ("pair4k.device_serial", "pair4k.host_inflight3"):
        out = run(name)
        assert not out["correct"]
        assert out["compared"]["pixel_max_d"]["value"] > 100


@pytest.mark.parametrize("name", ESTIMATE_ROW_CELLS)
def test_estimate_altered(monkeypatch, name):
    shifted_estimate(monkeypatch)
    out = run(name)
    assert not out["correct"]
    assert out["compared"]["h_err_px"]["value"] >= 1.5


def test_chain_blend_left_unchanged(monkeypatch):
    from pano_tpu_torch import pipeline
    real = pipeline.blend_global

    def no_warps(anchor, t_mat, ch, cw, warps, config, *rest):
        return real(anchor, t_mat, ch, cw, iter(()), config, *rest)
    monkeypatch.setattr(pipeline, "blend_global", no_warps)
    out = run("oilseed_chain.host_serial")
    assert not out["correct"]


def test_batch_half_left_out(monkeypatch):
    """Half of each batch left out, its answers taken from the rest."""
    from pano_tpu_torch.parallel import shard
    real = shard.stitch_pairs_batched

    def half(lefts, rights, *args, **kwargs):
        h = lefts.shape[0] // 2
        got = real(lefts[:h], rights[:h], *args, **kwargs)
        return got + got
    monkeypatch.setattr(shard, "stitch_pairs_batched", half)
    assert not run("pair4k.batch4_mesh4")["correct"]


def test_batch_exchange_between_cards_left_out(monkeypatch):
    """The estimates of every shard but the first never reach the first
    card: their rows arrive as zeros."""
    from pano_tpu_torch import pipeline
    from pano_tpu_torch.parallel import shard
    real_batch, real_row = shard.stitch_pairs_batched, pipeline.estimate_row
    calls = []

    def batch(*args, **kwargs):
        calls.clear()
        return real_batch(*args, **kwargs)

    def row(*args, **kwargs):
        est, pts = real_row(*args, **kwargs)
        calls.append(None)
        return (est if len(calls) == 1 else torch.zeros_like(est)), pts
    monkeypatch.setattr(shard, "stitch_pairs_batched", batch)
    monkeypatch.setattr(pipeline, "estimate_row", row)
    out = run("pair4k.batch4_mesh4")
    assert not out["correct"]
    assert out["compared"]["missing"]["value"] > 0


def test_batch_pixels_altered(monkeypatch):
    from pano_tpu_torch import pipeline
    real = pipeline._host_fetch

    def fetch(t):
        out = real(t)
        if out.dtype == np.uint8:
            out = out.copy()
            out[:, 40:50, 200:210] ^= 0x80
        return out
    monkeypatch.setattr(pipeline, "_host_fetch", fetch)
    assert not run("pair4k.batch4_mesh4")["correct"]


# --- the command ---------------------------------------------------------------


def test_command_without_a_card_fails_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "pano_bench.run", "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_command_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "pano_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    proc = subprocess.run(
        bench["command"] + ["--workload", CELLS[0], "--seed", "1",
                            "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
