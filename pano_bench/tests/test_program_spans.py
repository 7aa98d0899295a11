"""The program's own profiler ranges (``pano.<step>``, opened by the
port's ``timer.span``) land in the traced window beside the harness's
``pano_bench.`` spans. The readers of the layer spans and the breakdown
read the same with and without them; the readers of the program's
ranges read them."""

import pytest

from pano_bench.spec import Spec
from pano_bench.tests.test_arithmetic import canned, ev, make

SPEC = Spec()
# The readers of the program's ranges; every other reader reads the
# layer spans and the device alone.
PROGRAM_READERS = ["orchestration.host_syncs", "orchestration.upload_ms",
                   "compose.context.device_ms", "compose.context.launches"]
READERS = [m["name"] for m in SPEC.bench["per_layer"]
           if m["name"] not in PROGRAM_READERS]


def with_program_spans():
    """canned() with the port's ranges nested inside and around the
    harness's spans, launches included, on the same thread."""
    a = "user_annotation"
    return canned() + [
        ev(a, "pano.detect", 5, 10),
        ev(a, "pano.ransac", 20, 30),
        ev(a, "pano.ransac.search", 20, 15),
        ev(a, "pano.ransac.finalize", 35, 15),
        ev(a, "pano.wait", 55, 4),
        ev(a, "pano.upload", 61, 3),
        ev(a, "pano.compose", 72, 8),
        ev(a, "pano.compose.context", 73, 6),
        ev(a, "pano.geometry", 71, 1),
        ev(a, "pano.mesh", 0, 95),
    ]


@pytest.mark.parametrize("name", READERS)
def test_readers_ignore_program_spans(name):
    read = SPEC.reader(name)
    assert read(make(with_program_spans())) == read(make())


def test_breakdown_ignores_program_spans():
    assert make(with_program_spans()).breakdown() == make().breakdown()


# The canned trace's breakdown as the harness read it before it kept the
# program's ranges, with and without them.
BREAKDOWN = {
    "device_ops": [["warp_overlay_canvas_kernel", 5e-06],
                   ["harris_scores_kernel", 4e-06], ["Memcpy DtoH", 4e-06],
                   ["smallest_eigvec9_kernel", 3e-06], ["foo", 2e-06],
                   ["bar", 2e-06], ["Memset (Device)", 1e-06]],
    "idle_gaps": [["cuda:0 orchestration", 3.2e-05],
                  ["cuda:0 ransac", 1.4e-05],
                  ["cuda:0 orchestration", 1.2e-05],
                  ["cuda:0 orchestration", 1e-05],
                  ["cuda:0 orchestration", 8e-06],
                  ["cuda:0 outside spans", 4e-06],
                  ["cuda:0 outside spans", 1e-06]],
}


@pytest.mark.parametrize("events", [None, with_program_spans()],
                         ids=["layer_spans", "with_program_spans"])
def test_layer_spans_read_as_before(events):
    t = make(events)
    assert t.breakdown() == BREAKDOWN
    assert [layer for layer, *_ in t.spans] == \
        ["orchestration", "detect", "ransac", "orchestration", "compose"]
    assert t.launch_layers == [
        frozenset({"orchestration", "detect"}),
        frozenset({"orchestration", "ransac"}),
        frozenset({"orchestration", "ransac"}),
        frozenset({"orchestration", "compose"}), frozenset()]
    assert t.self_us("orchestration") == 32


def test_program_ranges_kept_apart():
    t = make(with_program_spans())
    assert len(t.program) == 10 and len(t.launches) == 5
    assert make().program == []
    assert t.program_count("wait") == 1
    assert t.program_span_us("upload") == 3
    assert t.program_kernel_us("compose.context") == 5   # correlation 4
    assert t.program_kernel_us("detect") == 4
    assert t.program_kernel_us("ransac") == 5
    assert t.program_kernel_us("mesh") == 16
    assert t.program_spans("ransac.search") == [(20.0, 35.0, 1)]


def test_program_count_takes_outermost_ranges_per_thread():
    """Two waits on thread 1, one nested in the other; one on thread 2
    inside thread 1's first; a range cut by the window's end still
    counts; one wholly after the window does not."""
    a = "user_annotation"
    events = [
        ev(a, "pano_bench.window", 0, 100),
        ev(a, "pano.wait", 10, 20),
        ev(a, "pano.wait", 12, 5),
        ev(a, "pano.wait", 14, 2, tid=2),
        ev(a, "pano.wait", 95, 10),
        ev(a, "pano.wait", 120, 5),
        ev("cuda_runtime", "cudaGraphLaunch", 13, 1, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 15, 1, tid=2, correlation=4),
        ev("kernel", "k", 20, 6, tid=7, device=0, correlation=3),
        ev("kernel", "k", 26, 2, tid=7, device=0, correlation=3),
        ev("kernel", "k", 40, 3, tid=7, device=0, correlation=4),
        ev("kernel", "k", 98, 5, tid=7, device=0, correlation=3),
    ]
    t = make(events)
    assert t.program_count("wait") == 3
    assert t.program_span_us("wait") == 20 + 2 + 10
    # the graph's three kernels, the last clipped to the window, and the
    # kernel launched from thread 2
    assert t.program_kernel_us("wait") == 6 + 2 + 2 + 3
    assert t.program_count("upload") == 0


@pytest.mark.parametrize("name,value", [
    ("orchestration.host_syncs", 1 / 2),
    ("orchestration.upload_ms", 3 / 1e3 / 2),
    ("compose.context.device_ms", 5 / 1e3 / 2),
])
def test_program_readers_on_the_canned_trace(name, value):
    read = SPEC.reader(name)
    assert read(make(with_program_spans())) == pytest.approx(value)
    assert read(make()) is None      # no range of the program


def test_program_readers_without_the_device():
    host_only = [e for e in with_program_spans()
                 if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    t = make(host_only)
    assert SPEC.reader("compose.context.device_ms")(t) is None
    assert SPEC.reader("orchestration.host_syncs")(t) == 1 / 2
