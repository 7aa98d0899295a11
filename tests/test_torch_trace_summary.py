"""tools/torch_trace_summary.py: the device-busy union and the per-name
table of a torch.profiler Chrome trace.

A hand-written trace holds overlapping kernels on two streams of one
device and a copy on a second device (the union is taken per device over
all its streams, where tools/xprof_summary.py takes the max over a TPU
plane's lines); a real CPU trace and one the port's CLI writes under
PANO_TPU_PROFILE exercise the host fallback.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch_trace_summary as tts  # noqa: E402

from pano_tpu_torch import cli as tcli  # noqa: E402
from pano_tpu_torch import io as tio  # noqa: E402


def _x(name, cat, pid, tid, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


# Device 0: stream 7 runs k_a at [0, 10) and [20, 30) us and k_c at
# [12, 13), stream 8 runs k_b at [5, 15) us: the union is [0, 15) +
# [20, 30) = 25 us, while the max over the streams would say 21. Device
# 1: a 4 us copy and a 2 us memset inside it. Host events, an annotation
# on the device's line and an instant event are not device work.
TRACE = {"traceEvents": [
    _x("k_a", "kernel", 0, 7, 0.0, 10.0),
    _x("k_a", "kernel", 0, 7, 20.0, 10.0),
    _x("k_b", "kernel", 0, 8, 5.0, 10.0),
    _x("k_c", "kernel", 0, 7, 12.0, 1.0),
    _x("Memcpy DtoH", "gpu_memcpy", 1, 13, 100.0, 4.0),
    _x("Memset", "gpu_memset", 1, 14, 101.0, 2.0),
    _x("aten::mm", "cpu_op", 4242, 4242, 0.0, 500.0),
    _x("ProfilerStep", "gpu_user_annotation", 0, 7, 0.0, 1000.0),
    {"ph": "i", "cat": "kernel", "name": "instant", "pid": 0, "tid": 7,
     "ts": 50.0},
]}


def _summary(trace, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tts.summarize(trace, **kw)
    return out.getvalue()


def test_busy_union_over_streams_summed_over_devices():
    assert tts.device_busy_ms(TRACE) == pytest.approx((25.0 + 4.0) / 1e3)
    # The union within one stream and over the device's two streams.
    assert tts._busy_union([(0, 10), (20, 30), (5, 15)]) == 25
    assert tts._busy_union([(0, 10), (2, 3), (10, 11)]) == 11
    assert tts._busy_union([]) == 0


def test_per_name_totals_and_counts():
    text = _summary(TRACE)
    assert "(no device events" not in text
    assert "=== device: 0  events=4  busy=0.025 ms ===" in text
    assert "=== device: 1  events=2  busy=0.004 ms ===" in text
    assert "-- stream: 7  events=3  busy=0.021 ms" in text
    assert "-- stream: 8  events=1  busy=0.010 ms" in text
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines()
            if line.startswith("  ")}
    assert rows["k_a"] == ["0.020", "ms", "x2"]
    assert rows["k_b"] == ["0.010", "ms", "x1"]
    assert rows["k_c"] == ["0.001", "ms", "x1"]
    assert "aten::mm" not in text and "ProfilerStep" not in text
    # --by-stream keeps the busy lines and drops the tables.
    short = _summary(TRACE, by_stream=True)
    assert "-- stream: 8  events=1  busy=0.010 ms" in short
    assert "k_a" not in short
    # --top limits each stream's table.
    top1 = _summary(TRACE, top=1)
    assert "k_a" in top1 and "k_c" not in top1


def _launch(ts, corr, tid=1):
    return {**_x("cudaLaunchKernel", "cuda_runtime", 9, tid, ts, 1.0),
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr, dev=0):
    return {**_x(name, "kernel", dev, 7, ts, dur),
            "args": {"correlation": corr}}


# Host thread 1 opens pano.ransac at [0, 100) us with pano.ransac.search
# [0, 60) and pano.ransac.finalize [60, 100) inside, and a second
# pano.ransac [200, 210) nested in another at [200, 250); pano.wait at
# [300, 340). Launches: 3 in search, 1 in finalize, 1 in the nested
# ransac, 1 on another thread at 20 us (outside every range of its
# thread), 1 outside any range. The card is busy [10, 30), [70, 80),
# [205, 215) and [320, 330).
STEPS = {"traceEvents": [
    _x("pano.ransac", "user_annotation", 9, 1, 0.0, 100.0),
    _x("pano.ransac.search", "user_annotation", 9, 1, 0.0, 60.0),
    _x("pano.ransac.finalize", "user_annotation", 9, 1, 60.0, 40.0),
    _x("pano.ransac", "user_annotation", 9, 1, 200.0, 50.0),
    _x("pano.ransac", "user_annotation", 9, 1, 200.0, 10.0),
    _x("pano.wait", "user_annotation", 9, 1, 300.0, 40.0),
    _x("pano_bench.ransac", "user_annotation", 9, 1, 0.0, 400.0),
    _launch(5.0, 1), _launch(8.0, 2), _launch(50.0, 3), _launch(65.0, 4),
    _launch(205.0, 5), _launch(20.0, 6, tid=2), _launch(150.0, 7),
    _kernel("k1", 10.0, 10.0, 1), _kernel("k2", 20.0, 10.0, 2),
    _kernel("k4", 70.0, 10.0, 4), _kernel("k5", 205.0, 10.0, 5),
    _x("Memcpy DtoH", "gpu_memcpy", 0, 8, 320.0, 10.0),
]}


def test_program_steps_of_a_canned_trace():
    steps = tts.program_steps(STEPS)
    assert set(steps) == {"pano.ransac", "pano.ransac.search",
                          "pano.ransac.finalize", "pano.wait"}
    r = steps["pano.ransac"]
    assert (r["ranges"], r["launches"]) == (3, 5)
    assert r["host_ms"] == pytest.approx(0.150)
    assert r["kernel_ms"] == pytest.approx(0.040)
    # Idle [0, 10) [30, 70) [80, 100) inside the first ransac, [200,
    # 205) [215, 250) inside the second.
    assert r["idle_ms"] == pytest.approx(0.110)
    s = steps["pano.ransac.search"]
    assert (s["launches"], s["kernel_ms"]) == (3, pytest.approx(0.020))
    f = steps["pano.ransac.finalize"]
    assert (f["launches"], f["kernel_ms"]) == (1, pytest.approx(0.010))
    w = steps["pano.wait"]
    assert (w["ranges"], w["launches"], w["idle_ms"]) == \
        (1, 0, pytest.approx(0.030))
    # A window clips the device time and drops the ranges outside it.
    clipped = tts.program_steps(STEPS, window=(0.0, 25.0))
    assert set(clipped) == {"pano.ransac", "pano.ransac.search"}
    assert clipped["pano.ransac"]["kernel_ms"] == pytest.approx(0.015)
    assert tts.program_steps(TRACE) == {}


def test_host_fallback_on_a_cpu_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            a = torch.mm(a, a).tanh()
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    trace = tts.load(path)
    assert tts.device_busy_ms(trace) == 0.0
    text = _summary(trace)
    assert text.startswith("(no device events in trace; summarizing host "
                           "cpu_op events)")
    assert "=== host process:" in text
    rows = {line.split()[0]: line.split() for line in text.splitlines()
            if line.startswith("  ")}
    assert rows["aten::mm"][-1] == "x3" and float(rows["aten::mm"][1]) > 0


def test_find_trace_picks_the_newest_and_refuses_an_empty_dir(tmp_path):
    (tmp_path / "sub").mkdir()
    old = tmp_path / "a.json"
    new = tmp_path / "sub" / "b.json"
    for p in (old, new):
        p.write_text(json.dumps(TRACE))
    os.utime(old, (time.time() - 100, time.time() - 100))
    assert tts.find_trace(str(tmp_path)) == str(new)
    assert tts.find_trace(str(old)) == str(old)
    with pytest.raises(SystemExit):
        tts.find_trace(str(tmp_path / "sub" / "none"))
    # A bare event list (the other Chrome trace form) loads too.
    (tmp_path / "list.json").write_text(json.dumps(TRACE["traceEvents"]))
    assert tts.device_busy_ms(tts.load(str(tmp_path / "list.json"))) == \
        pytest.approx(0.029)


def test_a_trace_written_by_the_port_cli(tmp_path, monkeypatch):
    """The port's CLI under PANO_TPU_PROFILE writes a trace the tool
    finds and summarizes (on the CPU: the host fallback), also as a
    script with --by-stream."""
    r = np.random.default_rng(0)
    base = np.full((96, 192, 3), 30, np.uint8)
    for _ in range(120):
        y, x = r.integers(4, 88), r.integers(4, 184)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    tio.write_ppm(str(tmp_path / "a1.ppm"), base[:, :128])
    tio.write_ppm(str(tmp_path / "a2.ppm"), base[:, 64:])
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PANO_TPU_PROFILE", str(trace_dir))
    with contextlib.redirect_stdout(io.StringIO()):
        rc = tcli.run("serial", ["--dir", str(tmp_path), "--out",
                                 str(tmp_path / "p.ppm"), "--kpts", "512",
                                 "--iters", "128"])
    assert rc == 0
    path = tts.find_trace(str(trace_dir))
    assert os.path.basename(path).startswith("pano_trace_")
    trace = tts.load(path)
    assert tts.device_busy_ms(trace) == 0.0
    assert "aten::" in _summary(trace, top=5)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_trace_summary.py"),
         str(trace_dir), "--by-stream"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == f"reading {path}"
    assert "-- thread:" in out.stdout and "aten::" not in out.stdout
    assert "=== program steps (pano. ranges) ===" in out.stdout
    steps = tts.program_steps(trace)
    assert steps["pano.ransac"]["ranges"] == 1
    assert steps["pano.detect"]["ranges"] == 2
    assert steps["pano.upload"]["ranges"] == 2
    assert lines[-1] == ("device busy (union over streams, summed over "
                         "devices): 0.000 ms")
