"""The percentile, union-busy, self-time, attribution and roofline
arithmetic, on canned traces."""

import numpy as np
import pytest

from pano_bench import roofline
from pano_bench import trace as tracing
from pano_bench.spec import Spec

STEPS = Spec().data("kernel_steps.json")


@pytest.mark.parametrize("n", [1, 2, 7, 20, 201])
@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear(n, q):
    xs = np.random.default_rng(n).exponential(10.0, n).tolist()
    assert tracing.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_union_clip_and_gaps():
    spans = [(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]
    assert tracing.union(spans) == [(0, 3), (5, 12), (20, 21)]
    assert tracing.union_length(spans) == 11
    assert tracing.clip(spans, 2, 10) == [(5, 9), (2, 3), (8, 10)]
    assert tracing.gaps(tracing.union(spans), -1, 25) == \
        [(-1, 0), (3, 5), (12, 20), (21, 25)]


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::harris_scores_kernel<1>(unsigned char "
     "const*, float*, int)", "harris_scores_kernel"),
    ("(anonymous namespace)::match_kernel(unsigned char const*, float*)",
     "match_kernel"),
    ("match_kernel", "match_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<float>)", "vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::"
     "native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 2, 64, "
     "64>(at::native::(anonymous namespace)::OpaqueType<4u>*)",
     "CatArrayBatchedCopy"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_cublas",
     "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_cublas"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_base(name, base):
    assert tracing.kernel_base(name) == base


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": args.get("device", 1), "args": args}


def canned():
    """Window 0..100 us. Host: orchestration 0..60 holding detect 5..15
    and ransac 20..50 (compose none); a second orchestration 70..90
    holding compose 72..80. Launches: one under detect, two under
    ransac, one under compose, one outside. Device 0: the kernels at
    their correlations, a memcpy, and a memset."""
    a = "user_annotation"
    return [
        ev(a, "pano_bench.window", 0, 100),
        ev(a, "pano_bench.orchestration", 0, 60),
        ev(a, "pano_bench.detect", 5, 10),
        ev(a, "pano_bench.ransac", 20, 30),
        ev(a, "pano_bench.orchestration", 70, 20),
        ev(a, "pano_bench.compose", 72, 8),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 73, 1, correlation=4),
        ev("cuda_runtime", "cudaLaunchKernel", 65, 1, correlation=5),
        ev("cuda_runtime", "cudaMemcpyAsync", 66, 1, correlation=6),
        ev("cpu_op", "aten::mul", 21, 2),
        ev("kernel", "void harris_scores_kernel<1>(int)", 8, 4, tid=7,
           device=0, correlation=1),
        ev("kernel", "void at::native::foo<1>(int)", 24, 2, tid=7,
           device=0, correlation=2),
        ev("kernel", "void smallest_eigvec9_kernel(float const*)", 40, 3,
           tid=7, device=0, correlation=3),
        ev("kernel", "void warp_overlay_canvas_kernel(int)", 75, 5, tid=7,
           device=0, correlation=4),
        ev("kernel", "void at::native::bar(int)", 76, 2, tid=9, device=0,
           correlation=5),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 90, 4, tid=7,
           device=0, correlation=6),
        ev("gpu_memset", "Memset (Device)", 95, 1, tid=7, device=0),
    ]


def make(events=None, devices=(0,)):
    t = tracing.Trace({"traceEvents": events or canned()},
                      {"panoramas": 2, "estimates": 2, "images": 4},
                      {"detect": 2e-6, "eigvec": 1e-6, "warp_compose": 4e-6},
                      STEPS, devices)
    return t


def test_attribution_and_host_times():
    t = make()
    assert t.window_us == 100
    assert t.self_us("orchestration") == (60 - 10 - 30) + (20 - 8)
    assert t.span_us("ransac") == 30
    assert t.launches_in("ransac") == 2
    assert t.kernel_us("detect") == 4
    assert t.kernel_us("ransac") == 5
    assert t.kernel_us("compose") == 5
    assert t.kernel_us() == 16
    assert t.memcpy_us() == 4
    assert t.step_kernel_us() == {"detect": 4, "eigvec": 3,
                                  "warp_compose": 5}
    # device 0 busy: 8-12, 24-26, 40-43, 75-80, 90-94, 95-96
    assert t.busy_us(0) == 4 + 2 + 3 + 5 + 4 + 1


def test_busy_is_clipped_to_the_window_and_spans_nested():
    events = canned() + [ev("kernel", "void late(int)", 98, 10, tid=7,
                            device=0, correlation=99)]
    t = make(events)
    assert t.busy_us(0) == 19 + 2


def test_overlap_across_devices():
    events = [ev("user_annotation", "pano_bench.window", 0, 100),
              ev("kernel", "k", 0, 50, device=0),
              ev("kernel", "k", 40, 20, device=1),
              ev("kernel", "k", 45, 30, device=2),
              ev("kernel", "k", 90, 5, device=3)]
    t = make(events, devices=(0, 1, 2, 3))
    assert t.overlap_us(2) == 20          # 40-60
    assert t.overlap_us(3) == 5           # 45-50


def test_breakdown_labels_gaps_by_the_host():
    t = make()
    b = t.breakdown(top=3)
    assert b["device_ops"][0] == ["warp_overlay_canvas_kernel", 5e-6]
    assert len(b["idle_gaps"]) == 3
    gap = b["idle_gaps"][0]     # 43..75: the host in neither span at 59
    assert gap[1] == pytest.approx(32e-6)
    assert gap[0].startswith("cuda:0 orchestration")


def test_trace_without_window_is_refused():
    with pytest.raises(ValueError):
        make(canned()[1:])


def test_roofline_share():
    got = roofline.roofline_pct({"detect": 2e-6, "eigvec": 1e-6,
                                 "warp_compose": 4e-6, "match": 9.0},
                                {"detect": 4.0, "eigvec": 3.0,
                                 "warp_compose": 5.0})
    assert got == pytest.approx(100.0 * 7.0 / 12.0)
    assert roofline.roofline_pct({"detect": 1.0}, {}) is None


def test_roofline_counts_of_the_4k_pair():
    """The pair's steps as PERF.md's kernel table has them: K1's bound
    0.0193 ms (operations), K3's 0.0130 (its f32 epilogue), K4a's 0.0389
    (bytes) on the 3154x5556 canvas, K7's ~1.5e-6 ms."""
    s = roofline.panorama_steps([(3117, 4156)] * 2, (3154, 5556), 8192, 5,
                                False)
    assert s["detect"] / 2 * 1e3 == pytest.approx(0.0193, rel=0.01)
    assert s["match"] * 1e3 == pytest.approx(0.0130, rel=0.01)
    assert s["warp_compose"] * 1e3 == pytest.approx(0.0389, rel=0.01)
    assert s["eigvec"] * 1e3 == pytest.approx(1.5e-6, rel=0.02)


def test_metric_readers_on_the_canned_trace():
    spec = Spec()
    t = make()
    want = {
        "orchestration.self_ms": 32 / 1e3 / 2,
        "ransac.host_ms": 30 / 1e3,
        "ransac.launches": 2.0,
        "detect.device_ms": 4 / 1e3 / 4,
        "match.device_ms": None,
        "compose.device_ms": 5 / 1e3 / 2,
        "copy.ms": 4 / 1e3 / 2,
        "kernels_roofline": 100.0 * 7e-6 * 1e6 / 12.0,
        "device.idle_pct": 100.0 * (1 - 19 / 100),
        "mesh.overlap_pct": None,
    }
    for name, value in want.items():
        got = spec.reader(name)(t)
        assert got == (None if value is None else pytest.approx(value)), name


def graph_trace():
    """Window 0..100 us: an orchestration span holding a ransac span
    that launches one CUDA graph of three kernels, and a compose span
    that launches nothing; no copies."""
    a = "user_annotation"
    return [
        ev(a, "pano_bench.window", 0, 100),
        ev(a, "pano_bench.orchestration", 0, 90),
        ev(a, "pano_bench.ransac", 10, 20),
        ev(a, "pano_bench.compose", 40, 10),
        ev("cuda_runtime", "cudaGraphLaunch", 12, 2, correlation=8),
        ev("kernel", "void at::native::foo<1>(int)", 20, 3, tid=7,
           device=0, correlation=8),
        ev("kernel", "void smallest_eigvec9_kernel(float const*)", 23, 2,
           tid=7, device=0, correlation=8),
        ev("kernel", "void at::native::bar(int)", 25, 4, tid=7, device=0,
           correlation=8),
    ]


def test_a_graphs_kernels_belong_to_the_span_of_its_launch():
    t = make(graph_trace())
    assert t.launches_in("ransac") == 1
    assert t.kernel_us("ransac") == 9
    assert t.kernel_us("orchestration") == 9
    assert t.step_kernel_us() == {"eigvec": 2}


@pytest.mark.parametrize("name,value", [
    ("ransac.launches", 1.0),
    ("compose.device_ms", 0.0),      # the span is there, no work under it
    ("copy.ms", 0.0),                # no copies
    ("detect.device_ms", None),      # no detect span
    ("match.device_ms", None),
])
def test_readers_under_a_graph_and_spans_with_no_work(name, value):
    got = Spec().reader(name)(make(graph_trace()))
    assert got == (None if value is None else pytest.approx(value))


@pytest.mark.parametrize("name", ["ransac.launches", "compose.device_ms",
                                  "copy.ms", "detect.device_ms",
                                  "device.idle_pct", "kernels_roofline"])
def test_device_readers_read_nothing_without_a_device(name):
    host_only = [e for e in canned()
                 if e["cat"] not in tracing.DEVICE_CATS]
    assert Spec().reader(name)(make(host_only)) is None


# A four-image chain's steps as the harness counted them before a
# traffic could say which pairs a panorama estimates.
CHAIN_STEPS = {"detect": 1.7961229850746268e-05,
               "describe": 3.7658746268656718e-06,
               "match": 3.9063368597014925e-05,
               "warp_compose": 1.870683671641791e-05,
               "eigvec": 4.548705882352941e-09}


def test_roofline_pairs_adjacent_by_default_and_all_pairs():
    args = ([(1502, 2003)] * 4, (1543, 5739), 8192, 5, True)
    assert roofline.panorama_steps(*args) == CHAIN_STEPS
    assert roofline.panorama_steps(*args, "adjacent") == CHAIN_STEPS
    every = roofline.panorama_steps(*args, "all")
    for step in ("detect", "describe", "warp_compose"):
        assert every[step] == CHAIN_STEPS[step]
    for step in ("match", "eigvec"):
        assert every[step] == pytest.approx(CHAIN_STEPS[step] * 6 / 3)


@pytest.mark.parametrize("n,pairs,want", [
    (2, "adjacent", 1), (4, "adjacent", 3), (2, "all", 1), (4, "all", 6),
    (12, "all", 66)])
def test_estimates_a_panorama(n, pairs, want):
    assert roofline.estimates(n, pairs) == want


def test_unknown_pairs_is_refused():
    with pytest.raises(ValueError):
        roofline.estimates(4, "tree")
