"""pano_tpu_torch.cli against pano_tpu.cli on the CPU.

The `serial` impl of both CLIs runs on the same small scenes: the same
exit codes, the same stdout and stderr lines (times blanked), panoramas
within tests/test_torch_multi.py's bar, and --json files with the same
keys, stage names and, on every field both configs have, the same
config. Each JAX run happens once per module. Then the port's own
surface: the error paths of tests/test_cli.py, `gpu` and `sharded`
without a CUDA device (an error, never a CPU run), `sharded` on the CPU
against the JAX CLI's, the profiler hook, and `serve` (decode-ahead, encode-behind, status lines,
failed jobs and writes, the staging decoder) on `serial`.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from pano_tpu import cli as jcli  # noqa: E402
from pano_tpu_torch import cli as tcli  # noqa: E402
from pano_tpu_torch import config as TC  # noqa: E402
from pano_tpu_torch import io as tio  # noqa: E402
from pano_tpu_torch import pipeline as TP  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME = re.compile(r"\d+\.\d{3} ms$", re.M)
# The port's own config fields, which the JAX package lacks, at the
# values the CLI runs them with: the direct alignment, off.
PORT_ONLY = {"ransac": {"align_iterations": 0}}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """tests/test_cli.py's two small overlapping textured images."""
    d = tmp_path_factory.mktemp("torch_cli_pair")
    r = np.random.default_rng(0)
    base = np.full((96, 192, 3), 30, np.uint8)
    for _ in range(120):
        y, x = r.integers(4, 88), r.integers(4, 184)
        base[y : y + 6, x : x + 6] = r.integers(60, 255, 3)
    cv2.imwrite(str(d / "a1.png"), base[:, :128])
    cv2.imwrite(str(d / "a2.png"), base[:, 64:])
    return str(d)


@pytest.fixture(scope="module")
def strip_dir(tmp_path_factory):
    """tests/test_torch_multi.py's three-image strip (50 % overlaps), as
    binary PPM."""
    d = tmp_path_factory.mktemp("torch_cli_strip")
    r = np.random.default_rng(2)
    base = r.integers(0, 60, (128, 280, 3)).astype(np.uint8)
    for _ in range(max(60, 128 * 280 // 150)):
        y, x = r.integers(2, 118), r.integers(2, 270)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    for i, x0 in enumerate((0, 70, 140)):
        tio.write_ppm(str(d / f"s{i}.ppm"), base[:, x0:x0 + 140])
    return str(d)


def _call(fn, *args, **kw):
    """(return code, stdout, stderr) of one CLI call; SystemExit becomes
    its code."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(*args, **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, out.getvalue(), err.getvalue()


# case -> (impl, scene, extra args)
CASES = {
    "pair_fold": ("serial", "pair", []),
    "pair_fold_feather": ("serial", "pair", ["--blend", "feather"]),
    "pair_parity": ("serial", "pair", ["--parity", "--kpts", "256",
                                       "--iters", "128"]),
    "pair_opencv": ("opencv", "pair", []),
    "strip_fold": ("serial", "strip", []),
    "strip_chain": ("serial", "strip", ["--mode", "chain"]),
    "strip_auto": ("serial", "strip", ["--mode", "auto", "--anchor",
                                       "first"]),
}


@pytest.fixture(scope="module")
def both_runs(scene_dir, strip_dir, tmp_path_factory):
    """case -> {"jax": ..., "port": ...}, each (rc, stdout, stderr,
    panorama or None, --json dict or None), computed once."""
    out_dir = tmp_path_factory.mktemp("torch_cli_out")
    memo = {}

    def get(case):
        if case not in memo:
            impl, scene, extra = CASES[case]
            d = scene_dir if scene == "pair" else strip_dir
            res = {}
            # One output path for both, so that the printed lines match;
            # each run's files are read and removed before the next.
            pano = str(out_dir / f"{case}.png")
            stats = str(out_dir / f"{case}.json")
            for side, mod in (("jax", jcli), ("port", tcli)):
                rc, out, err = _call(mod.run, impl, [
                    "--dir", d, "--out", pano, *extra, "--json", stats])
                res[side] = (
                    rc, out, err,
                    cv2.imread(pano) if os.path.exists(pano) else None,
                    json.load(open(stats)) if os.path.exists(stats) else None,
                )
                for f in (pano, stats):
                    if os.path.exists(f):
                        os.remove(f)
            memo[case] = res
        return memo[case]

    return get


def _pano_bar(got, want):
    """tests/test_torch_multi.py's bar: the canvas within a row and
    column, and (d > 3) on < 1 % of the shared pixels."""
    assert got is not None and want is not None
    assert all(abs(a - b) <= 1 for a, b in zip(got.shape, want.shape)), \
        (got.shape, want.shape)
    h, w = min(got.shape[0], want.shape[0]), min(got.shape[1], want.shape[1])
    d = np.abs(got[:h, :w].astype(int) - want[:h, :w].astype(int)).max(-1)
    assert (d > 3).mean() < 0.01, (d.max(), (d > 3).mean())


@pytest.mark.parametrize("case", sorted(CASES))
def test_serial_stdout_and_exit_code_match_jax(both_runs, case):
    rc_j, out_j, err_j, pano_j, _ = both_runs(case)["jax"]
    rc_t, out_t, err_t, pano_t, _ = both_runs(case)["port"]
    assert rc_t == rc_j
    assert TIME.sub("X ms", out_t).splitlines() == \
        TIME.sub("X ms", out_j).splitlines()
    assert err_t == err_j
    assert "Stitched result saved to" in out_t or CASES[case][0] == "opencv"
    if rc_j == 0:
        _pano_bar(pano_t, pano_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_json_matches_jax(both_runs, case):
    _, out_j, _, pano_j, s_j = both_runs(case)["jax"]
    _, out_t, _, pano_t, s_t = both_runs(case)["port"]
    assert s_t is not None and s_j is not None
    assert s_t.keys() == s_j.keys()
    for key in ("impl", "mode", "ok"):
        assert s_t[key] == s_j[key], key
    assert s_t["backend"] == "cpu" and s_t["num_devices"] == 1
    assert [r["stage"] for r in s_t["stages"]] == \
        [r["stage"] for r in s_j["stages"]]
    # Every stage record is a printed stage line.
    printed = [m.group(1) for m in re.finditer(r"^(.+): \d+\.\d{3} ms$",
                                               out_t, re.M)]
    assert [r["stage"] for r in s_t["stages"]] == printed
    for sub in ("harris", "ransac", "stitch"):
        own = PORT_ONLY.get(sub, {})
        assert {k: s_t["config"][sub][k] for k in own} == own, sub
        shared = s_t["config"][sub].keys() & s_j["config"][sub].keys()
        assert shared == s_t["config"][sub].keys() - own.keys()
        assert {k: s_t["config"][sub][k] for k in shared} == \
            {k: s_j["config"][sub][k] for k in shared}, sub
    if s_t["ok"]:
        assert s_t["panorama_shape"] == list(pano_t.shape)
        assert all(abs(a - b) <= 1 for a, b in
                   zip(s_t["panorama_shape"], s_j["panorama_shape"]))


def test_parity_preset_config(both_runs):
    s = both_runs("pair_parity")["port"][4]
    h = s["config"]["harris"]
    assert (h["ratio_thresh"], h["cross_check"], h["topk_method"]) == \
        (0.0, False, "exact")
    assert h["max_keypoints"] == 256 and s["config"]["ransac"][
        "num_iterations"] == 128
    assert s["config"]["stitch"]["blend"] == "overlay" and s["mode"] == "fold"
    # --parity implies the per-stage timing lines.
    assert "Harris Corner Detection: " in both_runs("pair_parity")["port"][1]


# --- error paths, against the JAX CLI (tests/test_cli.py:33-60) ----------

ERROR_CASES = {
    "unknown_impl": ("vulkan", []),
    "one_image": ("serial", ["{a1}"]),
    "no_images": ("serial", ["--out", "x.png"]),
    "flag_needs_value": ("serial", ["--mode"]),
    "bad_mode": ("serial", ["--mode", "spiral", "x.jpg", "y.jpg"]),
    "bad_blend": ("serial", ["--blend", "gradient", "x.jpg", "y.jpg"]),
    "bad_topk": ("serial", ["--topk", "sorta", "x.jpg", "y.jpg"]),
    "bad_bundle": ("serial", ["--bundle", "sometimes", "x.jpg", "y.jpg"]),
    "bad_onoff": ("serial", ["--gain", "maybe", "x.jpg", "y.jpg"]),
    "unreadable_files": ("serial", ["{nope}/a.jpg", "{nope}/b.jpg"]),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_paths_match_jax(case, scene_dir, tmp_path):
    impl, args = ERROR_CASES[case]
    args = [a.format(a1=os.path.join(scene_dir, "a1.png"),
                     nope=str(tmp_path)) for a in args]
    rc_j, out_j, err_j = _call(jcli.run, impl, list(args))
    rc_t, out_t, err_t = _call(tcli.run, impl, list(args))
    assert rc_t == rc_j and rc_t in (-1, ("exit", -1))
    assert out_t == out_j == ""
    if case == "unknown_impl":  # the impl list names the port's impls
        assert err_t.splitlines()[0] == err_j.splitlines()[0] == \
            "Unknown implementation: vulkan"
    else:
        assert err_t == err_j


def test_config_validation_raises_like_jax():
    for mod in (jcli, tcli):
        with pytest.raises(ValueError):
            mod.run("serial", ["--topk-recall", "1.5", "x.jpg", "y.jpg"])
        with pytest.raises(ValueError):
            mod.run("serial", ["--nms-size", "4", "x.jpg", "y.jpg"])


def test_main_usage_and_exit_codes(capsys):
    assert tcli.main([]) == -1
    assert "python -m pano_tpu_torch.cli serve <impl>" in \
        capsys.readouterr().err
    assert tcli.main(["serve"]) == -1
    assert "Usage" in capsys.readouterr().err


# --- the port's own surface ---------------------------------------------

def test_repeated_flag_last_wins(scene_dir, tmp_path):
    stats = str(tmp_path / "s.json")
    rc, _, _ = _call(tcli.run, "serial", [
        "--dir", scene_dir, "--out", str(tmp_path / "p.png"),
        "--mode", "fold", "--mode", "chain", "--kpts", "9", "--kpts", "256",
        "--json", stats])
    assert rc == 0
    s = json.load(open(stats))
    assert s["mode"] == "chain" and s["config"]["harris"][
        "max_keypoints"] == 256


def test_full_flag_surface_reaches_config(scene_dir, tmp_path):
    """tests/test_cli.py's full flag surface, every value in the port's
    config, and the run ends well."""
    out = str(tmp_path / "pano.png")
    stats = str(tmp_path / "stats.json")
    rc, stdout, _ = _call(tcli.run, "serial", [
        "--dir", scene_dir, "--out", out,
        "--mode", "chain", "--blend", "feather", "--gain", "on",
        "--bundle", "off",
        "--k", "0.05", "--nms-thresh", "5e5", "--nms-size", "5",
        "--patch", "5", "--ssd-thresh", "1e9", "--kpts", "256",
        "--ratio", "0.9", "--cross-check", "on", "--topk", "exact",
        "--topk-recall", "0.9", "--match-block", "64",
        "--iters", "128", "--dist", "2.0", "--seed", "3",
        "--refine", "off", "--min-inliers", "8",
        "--json", stats,
    ])
    assert rc == 0 and os.path.exists(out)
    s = json.load(open(stats))
    want = TC.PanoConfig(
        harris=TC.HarrisOptions(
            k=0.05, nms_thresh=5e5, nms_neighborhood=5, patch_size=5,
            max_ssd_thresh=1e9, max_keypoints=256, ratio_thresh=0.9,
            cross_check=True, topk_method="exact", topk_recall=0.9,
            match_block=64),
        ransac=TC.RansacOptions(num_iterations=128, distance_threshold=2.0,
                                seed=3, refine=False, min_inliers=8),
        stitch=TC.StitchOptions(blend="feather", gain_compensation=True,
                                bundle_adjust="off"),
    )
    assert s["config"] == {"harris": dataclasses.asdict(want.harris),
                           "ransac": dataclasses.asdict(want.ransac),
                           "stitch": dataclasses.asdict(want.stitch)}
    assert s["ok"] and s["panorama_shape"] == list(cv2.imread(out).shape)


def test_warmup_stays_out_of_json(scene_dir, tmp_path):
    stats = str(tmp_path / "s.json")
    rc, stdout, _ = _call(tcli.run, "serial", [
        "--dir", scene_dir, "--out", str(tmp_path / "p.png"), "--warmup",
        "--mode", "chain", "--json", stats])
    assert rc == 0
    assert stdout.count("Total Stitching Process: ") == 2
    assert [r["stage"] for r in json.load(open(stats))["stages"]] == [
        "Total Stitching Process", "Total Execution Time"]


@pytest.mark.parametrize("impl", ["gpu", "tpu"])
def test_gpu_without_a_card_fails_and_never_runs_on_cpu(
        impl, scene_dir, tmp_path, monkeypatch):
    """No CUDA device here: gpu (and its alias tpu) report it on stderr and
    return -1 without stitching or writing anything."""
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_stitch(*a, **k):
        raise AssertionError("gpu ran a stitch without a CUDA device")

    monkeypatch.setattr(TP, "stitch_all_images", no_stitch)
    out = str(tmp_path / "p.png")
    stats = str(tmp_path / "s.json")
    rc, stdout, stderr = _call(tcli.run, impl, [
        "--dir", scene_dir, "--out", out, "--json", stats])
    assert rc == -1 and stdout == ""
    assert "needs a CUDA device" in stderr
    assert not os.path.exists(out) and not os.path.exists(stats)


def test_gpu_without_a_card_exits_255(scene_dir, tmp_path):
    out = str(tmp_path / "p.png")
    env = {k: v for k, v in os.environ.items() if k != "PANO_TPU_FORCE_CPU"}
    r = subprocess.run(
        [sys.executable, "-m", "pano_tpu_torch.cli", "gpu", "--dir",
         scene_dir, "--out", out],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 255, r.stdout + r.stderr
    assert "needs a CUDA device" in r.stderr and r.stdout == ""
    assert not os.path.exists(out)


def test_force_cpu_runs_gpu_impl_on_cpu(scene_dir, tmp_path, monkeypatch):
    """PANO_TPU_FORCE_CPU (pano.sh --no-gpu) is the explicit request for
    the CPU: gpu then runs there, with its default total timing and no
    device tag."""
    monkeypatch.setenv("PANO_TPU_FORCE_CPU", "1")
    out = str(tmp_path / "p.png")
    stats = str(tmp_path / "s.json")
    rc, stdout, _ = _call(tcli.run, "gpu", [
        "--dir", scene_dir, "--out", out, "--json", stats])
    assert rc == 0
    lines = TIME.sub("X ms", stdout).splitlines()
    assert lines == [
        "PyTorch backend: cpu", "Number of Available Devices: 1",
        "Stitching image 2 of 2...", "Image Stitching: X ms",
        "Total Stitching Process: X ms", f"Stitched result saved to {out}",
        "", "Total Execution Time: X ms"]
    s = json.load(open(stats))
    assert (s["impl"], s["backend"], s["ok"]) == ("gpu", "cpu", True)


# case -> (impl, scene, extra args): the sharded impl (and its alias)
# against the JAX CLI's on its 8 CPU devices; the port runs on the CPU
# when asked (PANO_TPU_FORCE_CPU), on a mesh of one CPU device.
SHARDED_CASES = {
    "sharded": ("sharded", "strip", ["--mode", "chain"]),
    "openmp": ("openmp", "pair", []),
    "sharded_auto": ("sharded", "strip", ["--mode", "auto", "--anchor",
                                          "first"]),
}


@pytest.fixture(scope="module")
def sharded_runs(scene_dir, strip_dir, tmp_path_factory):
    """case -> {"jax": ..., "port": ...}, as both_runs."""
    out_dir = tmp_path_factory.mktemp("torch_cli_sharded")
    memo = {}

    def get(case):
        if case not in memo:
            impl, sc, extra = SHARDED_CASES[case]
            d = scene_dir if sc == "pair" else strip_dir
            pano = str(out_dir / f"{case}.png")
            stats = str(out_dir / f"{case}.json")
            res = {}
            saved = os.environ.get("PANO_TPU_FORCE_CPU")
            os.environ["PANO_TPU_FORCE_CPU"] = "1"
            try:
                for side, mod in (("jax", jcli), ("port", tcli)):
                    rc, out, err = _call(mod.run, impl, [
                        "--dir", d, "--out", pano, *extra, "--json", stats])
                    res[side] = (
                        rc, out, err,
                        cv2.imread(pano) if os.path.exists(pano) else None,
                        json.load(open(stats)) if os.path.exists(stats)
                        else None,
                    )
                    for f in (pano, stats):
                        if os.path.exists(f):
                            os.remove(f)
            finally:
                if saved is None:
                    del os.environ["PANO_TPU_FORCE_CPU"]
                else:
                    os.environ["PANO_TPU_FORCE_CPU"] = saved
            memo[case] = res
        return memo[case]

    return get


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_stdout_and_exit_code_match_jax(sharded_runs, case):
    """Line for line after the backend and device-count lines (JAX names
    itself and its 8 virtual devices there), the tag "Sharded" on every
    stage line; the panorama within the bar."""
    rc_j, out_j, err_j, pano_j, _ = sharded_runs(case)["jax"]
    rc_t, out_t, err_t, pano_t, _ = sharded_runs(case)["port"]
    assert rc_t == rc_j == 0
    lines_t = TIME.sub("X ms", out_t).splitlines()
    lines_j = TIME.sub("X ms", out_j).splitlines()
    assert lines_t[:2] == ["PyTorch backend: cpu",
                           "Number of Available Devices: 1"]
    assert lines_j[:2] == ["JAX backend: cpu",
                           "Number of Available Devices: 8"]
    assert lines_t[2:] == lines_j[2:]
    assert lines_t[-1] == "Total Execution Time (Sharded): X ms"
    assert all("(Sharded): X ms" in x for x in lines_t if x.endswith(" ms"))
    assert err_t == err_j
    _pano_bar(pano_t, pano_j)


@pytest.mark.parametrize("case", sorted(SHARDED_CASES))
def test_sharded_json_matches_jax(sharded_runs, case):
    _, _, _, _, s_j = sharded_runs(case)["jax"]
    _, out_t, _, pano_t, s_t = sharded_runs(case)["port"]
    assert s_t.keys() == s_j.keys()
    for key in ("impl", "mode", "ok"):
        assert s_t[key] == s_j[key], key
    assert s_t["impl"] == "sharded"
    assert s_t["backend"] == "cpu" and s_t["num_devices"] == 1
    assert [r["stage"] for r in s_t["stages"]] == \
        [r["stage"] for r in s_j["stages"]]
    printed = [m.group(1) for m in re.finditer(r"^(.+): \d+\.\d{3} ms$",
                                               out_t, re.M)]
    assert [r["stage"] for r in s_t["stages"]] == printed
    assert s_t["panorama_shape"] == list(pano_t.shape)


@pytest.mark.parametrize("impl", ["sharded", "openmp"])
def test_sharded_without_a_card_fails_and_reads_no_image(
        impl, scene_dir, tmp_path, monkeypatch):
    """No CUDA device here: sharded (and its alias openmp) report it on
    stderr and return -1 before reading an image or stitching."""
    assert not torch.cuda.is_available()
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)

    def no_read(*a, **k):
        raise AssertionError("sharded read images without a CUDA device")

    monkeypatch.setattr(tcli, "read_images_from_args", no_read)
    out = str(tmp_path / "p.png")
    rc, stdout, stderr = _call(tcli.run, impl, ["--dir", scene_dir, "--out",
                                                out])
    assert rc == -1 and stdout == ""
    assert "the sharded implementation needs a CUDA device" in stderr
    assert not os.path.exists(out)


def test_sharded_without_a_card_exits_255(scene_dir, tmp_path):
    out = str(tmp_path / "p.png")
    env = {k: v for k, v in os.environ.items() if k != "PANO_TPU_FORCE_CPU"}
    r = subprocess.run(
        [sys.executable, "-m", "pano_tpu_torch.cli", "sharded", "--mode",
         "chain", "--dir", scene_dir, "--out", out],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 255, r.stdout + r.stderr
    assert "needs a CUDA device" in r.stderr and r.stdout == ""
    assert not os.path.exists(out)


def test_profile_hook_writes_a_chrome_trace(scene_dir, tmp_path,
                                            monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PANO_TPU_PROFILE", str(trace_dir))
    rc, stdout, _ = _call(tcli.run, "serial", [
        "--dir", scene_dir, "--out", str(tmp_path / "p.png"),
        "--mode", "chain"])
    assert rc == 0
    assert f"Profiling to {trace_dir} (torch.profiler)" in stdout
    traces = list(trace_dir.glob("pano_trace_*.json"))
    assert len(traces) == 1
    events = json.load(open(traces[0]))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # The program's own layer spans (timer.span) are in the same trace.
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"pano.upload", "pano.detect", "pano.match", "pano.ransac",
            "pano.ransac.search", "pano.ransac.finalize", "pano.compose",
            "pano.geometry"} <= spans


def test_run_accepts_preloaded_tensors(scene_dir, tmp_path):
    """serve's worker may hand run() images already on the device
    (tensors): the panorama is the one from host arrays."""
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    host = {p: cv2.imread(p) for p in (a1, a2)}
    dev = {p: torch.from_numpy(v) for p, v in host.items()}
    out_h = str(tmp_path / "host.png")
    out_d = str(tmp_path / "dev.png")
    assert _call(tcli.run, "serial", [a1, a2, "--out", out_h],
                 _preloaded=host)[0] == 0
    assert _call(tcli.run, "serial", [a1, a2, "--out", out_d],
                 _preloaded=dev)[0] == 0
    np.testing.assert_array_equal(cv2.imread(out_h), cv2.imread(out_d))


# --- serve (tests/test_cli.py:192-496, on serial) ------------------------

STATUS = re.compile(r"Job \d+ (ok|failed) \S+: \d+\.\d{3} ms")


def test_serve_runs_jobs_and_reports_status(scene_dir, tmp_path):
    out1 = str(tmp_path / "serve1.png")
    out2 = str(tmp_path / "serve2.png")
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    jobs = io.StringIO(
        f"{a1} {a2} --out {out1}\n"
        "\n"                                     # blank: ignored
        f"{a1} --out {tmp_path / 'nope.png'}\n"  # 1 image: fails
        'broken "quoting\n'                      # shlex error: fails
        f"{a1} {a2} --out {out2} --blend feather\n"
        "quit\n"
        f"{a1} {a2} --out {tmp_path / 'after_quit.png'}\n"
    )
    rc, stdout, stderr = _call(tcli.serve, "serial", ["--kpts", "256"],
                               stdin=jobs)
    assert rc == 0
    statuses = [x for x in stdout.splitlines() if x.startswith("Job ")]
    assert [s.split(":")[0] for s in statuses] == [
        f"Job 1 ok {out1}", f"Job 2 failed {tmp_path / 'nope.png'}",
        "Job 3 failed -", f"Job 4 ok {out2}"]
    assert all(STATUS.fullmatch(s) for s in statuses), statuses
    assert "job 3 parse error" in stderr
    assert "At least two images are required" in stderr
    assert cv2.imread(out1).shape[1] >= 128 and os.path.exists(out2)
    assert not os.path.exists(tmp_path / "after_quit.png")


def test_serve_status_lines_match_jax(scene_dir, tmp_path):
    """The same jobs through both serve loops: the same lines, the times
    blanked (the port names itself in the banner)."""
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    outs = {}
    for side, mod in (("jax", jcli), ("port", tcli)):
        jobs = io.StringIO(
            f"{a1} {a2} --out {tmp_path / 'o.png'}\n"
            f"{a1} --out {tmp_path / 'x.png'}\n"
        )
        rc, stdout, _ = _call(mod.serve, "serial", [], stdin=jobs)
        assert rc == 0
        outs[side] = TIME.sub("X ms", stdout).splitlines()
    assert outs["port"][0].startswith("pano_tpu_torch serve (serial)")
    assert outs["port"][1:] == outs["jax"][1:]


def test_serve_decode_ahead_prefetches_next_job(scene_dir, tmp_path,
                                                monkeypatch):
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    seen = []
    real_run = tcli.run

    def spy(impl, args, config=None, _info=None, _preloaded=None, **kw):
        seen.append(None if _preloaded is None else sorted(_preloaded))
        return real_run(impl, args, _info=_info, _preloaded=_preloaded,
                        **kw)

    monkeypatch.setattr(tcli, "run", spy)
    jobs = io.StringIO(
        f"{a1} {a2} --out {tmp_path / 'p1.png'}\n"
        f"--kpts 200 {a1} --out {tmp_path / 'p2.png'} --mode chain {a2}\n"
        "quit\n"
    )
    rc, _, _ = _call(tcli.serve, "serial", ["--kpts", "256"], stdin=jobs)
    assert rc == 0
    assert seen == [None, sorted([a1, a2])]  # the second decoded ahead
    assert os.path.exists(tmp_path / "p1.png")
    assert os.path.exists(tmp_path / "p2.png")


def test_serve_encode_behind_defers_write_off_main_thread(
        scene_dir, tmp_path, monkeypatch):
    out1 = str(tmp_path / "eb1.png")
    out2 = str(tmp_path / "eb2.png")
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    on_main = []
    real_write = tcli.imwrite_bgr

    def spy_write(path, img):
        on_main.append(threading.current_thread() is threading.main_thread())
        return real_write(path, img)

    monkeypatch.setattr(tcli, "imwrite_bgr", spy_write)
    jobs = io.StringIO(f"{a1} {a2} --out {out1}\n{a1} {a2} --out {out2}\n")
    rc, stdout, _ = _call(tcli.serve, "serial", ["--kpts", "256"],
                          stdin=jobs)
    assert rc == 0
    lines = stdout.splitlines()
    statuses = [x for x in lines if x.startswith("Job ")]
    assert [s.split()[:3] for s in statuses] == [
        ["Job", "1", "ok"], ["Job", "2", "ok"]]
    # Each 'saved' line comes before its own status line.
    for n, out in ((1, out1), (2, out2)):
        assert lines.index(f"Stitched result saved to {out}") < \
            lines.index(next(s for s in statuses if s.startswith(f"Job {n} ")))
    assert cv2.imread(out1) is not None and cv2.imread(out2) is not None
    assert on_main and not any(on_main), on_main


def test_serve_encode_behind_reports_failed_write(scene_dir, tmp_path):
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    bad_out = str(tmp_path / "no_such_dir" / "x.png")
    good_out = str(tmp_path / "ok.png")
    jobs = io.StringIO(f"{a1} {a2} --out {bad_out}\n"
                       f"{a1} {a2} --out {good_out}\nquit\n")
    rc, stdout, stderr = _call(tcli.serve, "serial", ["--kpts", "256"],
                               stdin=jobs)
    assert rc == 0
    assert f"Job 1 failed {bad_out}:" in stdout
    assert f"Job 2 ok {good_out}:" in stdout
    assert f"Stitched result saved to {bad_out}" not in stdout
    assert "job 1 encode error" in stderr
    assert not os.path.exists(bad_out) and os.path.exists(good_out)


def test_serve_gpu_without_a_card_fails_each_job(scene_dir, tmp_path,
                                                 monkeypatch):
    monkeypatch.delenv("PANO_TPU_FORCE_CPU", raising=False)
    a1 = os.path.join(scene_dir, "a1.png")
    a2 = os.path.join(scene_dir, "a2.png")
    out = str(tmp_path / "g.png")
    rc, stdout, stderr = _call(tcli.serve, "gpu", [],
                               stdin=io.StringIO(f"{a1} {a2} --out {out}\n"))
    assert rc == 0
    assert "Job 1 failed -:" in stdout and "needs a CUDA device" in stderr
    assert not os.path.exists(out)


def test_staging_decoder_cache_hit_invalidate_evict(scene_dir, tmp_path,
                                                    monkeypatch):
    """Repeated paths come from the LRU (one decode per distinct file), a
    rewritten file is decoded again, the LRU evicts at capacity, and an
    unreadable path maps to None and is never cached."""
    import shutil
    import time

    a1 = os.path.join(scene_dir, "a1.png")
    b2 = str(tmp_path / "b2.png")
    shutil.copy(os.path.join(scene_dir, "a2.png"), b2)
    real_imread = tio.imread_bgr
    decoded = []

    def counting_imread(path):
        decoded.append(path)
        return real_imread(path)

    monkeypatch.setattr(tio, "imread_bgr", counting_imread)
    dec = tcli.make_staging_decoder(push_dev=None, cache_cap=2)
    first = dec([a1, b2])
    assert decoded == [a1, b2]
    again = dec([a1, b2])
    assert decoded == [a1, b2]
    assert again[a1] is first[a1] and again[b2] is first[b2]

    time.sleep(0.01)
    cv2.imwrite(b2, np.ascontiguousarray(cv2.imread(b2)[:, ::-1]))
    fresh = dec([b2])
    assert decoded == [a1, b2, b2]
    assert not np.array_equal(fresh[b2], first[b2])

    c3 = str(tmp_path / "c3.png")
    shutil.copy(a1, c3)
    dec([c3])
    dec([a1])  # evicted by c3: decoded again
    assert decoded == [a1, b2, b2, c3, a1]

    missing = str(tmp_path / "nope.png")
    assert dec([missing])[missing] is None
    assert dec([missing])[missing] is None
    assert decoded.count(missing) == 2


def test_staging_failure_is_reported_and_hands_back_the_host_array(
        scene_dir, capsys):
    """push_image copies to a CUDA device only; staging on the CPU fails,
    and the decoder says so on stderr and returns the decoded array."""
    from pano_tpu_torch.timer import push_image

    a1 = os.path.join(scene_dir, "a1.png")
    with pytest.raises(ValueError, match="CUDA"):
        push_image(cv2.imread(a1), torch.device("cpu"))
    dec = tcli.make_staging_decoder(push_dev=torch.device("cpu"),
                                    cache_cap=2)
    got = dec([a1])[a1]
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, cv2.imread(a1))
    err = capsys.readouterr().err
    assert f"staging {a1} on cpu failed" in err and "CUDA" in err
