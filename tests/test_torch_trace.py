"""The port's profiler spans (``timer.span``) on the CPU: which ``pano.``
ranges a pair, a chain, auto mode and an upload open under
``torch.profiler``, how the RANSAC steps and auto mode's graph nest, and
that nothing enters ``record_function`` when no profiler records. The
host waits, which only a card has, are tested on the card
(tests/test_torch_cuda.py)."""

import collections
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from pano_tpu_torch import PanoConfig, PairStitcher, pipeline  # noqa: E402
from pano_tpu_torch import timer  # noqa: E402
from pano_tpu_torch.config import (HarrisOptions, RansacOptions,  # noqa: E402
                                   StitchOptions)
from pano_tpu_torch.parallel import shard  # noqa: E402


def _scene(seed=57, h=128, w=300):
    """Dark noise under bright squares: corners that match unambiguously."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 60, (h, w, 3)).astype(np.uint8)
    for _ in range(w):
        y, x = r.integers(2, h - 10), r.integers(2, w - 10)
        base[y:y + 6, x:x + 6] = r.integers(60, 255, 3)
    return base


def _config(blend="overlay"):
    return PanoConfig(harris=HarrisOptions(max_keypoints=512),
                      ransac=RansacOptions(num_iterations=200),
                      stitch=StitchOptions(blend=blend))


def _spans(fn, tmp_path):
    """Run `fn` under a CPU profiler; returns (its result, the ``pano.``
    ranges of the Chrome trace as (name, start, end, tid))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]
    return out, [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and e["name"].startswith("pano.")]


def _count(spans):
    return collections.Counter(name for name, *_ in spans)


def test_pair_opens_each_layer_span(tmp_path):
    base = _scene()
    left = torch.from_numpy(base[:, 48:208].copy())
    right = torch.from_numpy(base[:, :160].copy())
    st = PairStitcher(_config(), print_timing=False, device="cpu")
    pano, spans = _spans(lambda: st.stitch_pair_fast(left, right), tmp_path)
    assert pano is not None
    assert _count(spans) == {
        "pano.detect": 2, "pano.match": 2, "pano.ransac": 1,
        "pano.ransac.search": 1, "pano.ransac.finalize": 1,
        "pano.compose": 1, "pano.geometry": 1}
    (_, s, e, tid), = [x for x in spans if x[0] == "pano.ransac"]
    for step in ("pano.ransac.search", "pano.ransac.finalize"):
        (_, a, b, t), = [x for x in spans if x[0] == step]
        assert t == tid and s <= a <= b <= e, step


@pytest.mark.parametrize("blend,n,contexts", [
    ("multiband", 3, 2),   # one window context a multiband step
    ("multiband", 2, 1),
    ("feather", 3, 0),     # the kernel step: no torch window work
])
def test_chain_of_host_images_uploads_each_and_marks_each_context(
        tmp_path, blend, n, contexts):
    base = _scene(w=160 + 70 * (n - 1))
    images = [base[:, 70 * i:70 * i + 160].copy() for i in range(n)]
    pano, spans = _spans(lambda: pipeline.stitch_all_images_chain(
        images, _config(blend), False, "", "cpu"), tmp_path)
    assert pano is not None
    counts = _count(spans)
    assert counts["pano.upload"] == n
    assert counts["pano.compose.context"] == contexts
    assert counts["pano.compose"] == 1 and counts["pano.geometry"] == 1
    assert counts["pano.ransac"] == n - 1


@pytest.mark.parametrize("bundle_adjust,bundles", [("auto", 1), ("off", 0)])
def test_auto_opens_an_estimate_span_a_pair_and_one_graph(
        tmp_path, monkeypatch, bundle_adjust, bundles):
    """Auto mode on a 2x2 grid (a cycle of four pairs and two diagonals):
    n(n - 1)/2 = 6 ``pano.estimate`` ranges, each holding its pair's match
    and RANSAC; one ``pano.graph`` after the rows' fetch; and
    ``pano.bundle`` inside it only where the bundle gate fires."""
    from pano_tpu_torch.ops import bundle
    refined = []
    real = bundle.refine_globals
    monkeypatch.setattr(bundle, "refine_globals", lambda *a, **k: (
        refined.append(None), real(*a, **k))[1])
    base = _scene(seed=5, h=220, w=260)
    images = [base[y:y + 160, x:x + 200].copy()
              for x, y in ((0, 0), (60, 2), (3, 58), (62, 60))]
    cfg = _config()
    cfg = cfg.replace(stitch=dataclasses.replace(
        cfg.stitch, bundle_adjust=bundle_adjust))
    pano, spans = _spans(lambda: pipeline.stitch_all_images(
        images, cfg, False, "", "cpu", mode="auto"), tmp_path)
    assert pano is not None and len(refined) == bundles
    counts = _count(spans)
    assert counts["pano.estimate"] == 6 and counts["pano.ransac"] == 6
    assert counts["pano.graph"] == 1
    assert counts["pano.bundle"] == bundles
    (_, gs, ge, gtid), = [x for x in spans if x[0] == "pano.graph"]
    for name, s, e, tid in spans:
        if name == "pano.bundle":
            assert tid == gtid and gs <= s <= e <= ge
        if name in ("pano.ransac", "pano.match"):
            assert any(n == "pano.estimate" and t == tid and a <= s <= e <= b
                       for n, a, b, t in spans), name
    assert all(e <= gs for name, s, e, _ in spans
               if name == "pano.estimate")


@pytest.mark.parametrize("to", [
    lambda x: pipeline._to_device(x, "cpu"),
    lambda x: shard._to(x, torch.device("cpu")),
], ids=["pipeline", "shard"])
@pytest.mark.parametrize("host,uploads", [(True, 1), (False, 0)],
                         ids=["numpy", "resident"])
def test_upload_span_only_for_a_host_image(tmp_path, to, host, uploads):
    img = _scene(h=16, w=24)
    x = img if host else torch.from_numpy(img)
    out, spans = _spans(lambda: to(x), tmp_path)
    assert torch.equal(out, torch.from_numpy(img))
    assert _count(spans) == ({"pano.upload": uploads} if uploads else {})


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler, span hands out one shared null context and
    never builds a record_function: with record_function made to raise,
    a whole pair and chain still run."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first = timer.span("detect")
    assert all(timer.span(name) is first
               for name in ("detect", "ransac.search", "wait", "upload"))
    with first:
        pass
    base = _scene()
    st = PairStitcher(_config(), print_timing=False, device="cpu")
    assert st.stitch_pair_fast(base[:, 48:208].copy(),
                               base[:, :160].copy()) is not None
    images = [base[:, 70 * i:70 * i + 160].copy() for i in range(2)]
    assert pipeline.stitch_all_images_chain(
        images, _config("multiband"), False, "", "cpu") is not None
    images.append(base[:, 140:300].copy())
    assert pipeline.stitch_all_images(
        images, _config(), False, "", "cpu", mode="auto") is not None

