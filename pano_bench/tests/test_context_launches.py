"""``compose.context.launches`` on canned traces: the kernels launched
inside the program's ``pano.compose.context`` ranges, a panorama."""

from pano_bench.spec import Spec
from pano_bench.tests.test_arithmetic import canned, ev, make

READ = Spec().reader("compose.context.launches")
A = "user_annotation"


def test_counts_the_kernels_launched_inside_the_range():
    """Two context ranges on thread 1: three kernels launched inside them
    (one from a CUDA graph's launch, which carries two kernels), one
    launched between them, one inside a range of thread 2 only; a memcpy
    inside does not count. Two panoramas."""
    events = canned() + [
        ev(A, "pano.compose.context", 72, 3),
        ev(A, "pano.compose.context", 77, 2),
        ev(A, "pano.compose.context", 60, 30, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 72.5, 0.1, correlation=10),
        ev("cuda_runtime", "cudaGraphLaunch", 77.5, 0.1, correlation=11),
        ev("cuda_runtime", "cudaLaunchKernel", 76, 0.1, correlation=12),
        ev("cuda_runtime", "cudaMemcpyAsync", 78, 0.1, correlation=13),
        ev("kernel", "k", 80, 1, tid=7, device=0, correlation=10),
        ev("kernel", "k", 81, 1, tid=7, device=0, correlation=11),
        ev("kernel", "k", 82, 1, tid=7, device=0, correlation=11),
        ev("kernel", "k", 83, 1, tid=7, device=0, correlation=12),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 84, 1, tid=7,
           device=0, correlation=13),
    ]
    # canned()'s own launch at 73 (correlation 4) lies in the first range
    assert READ(make(events)) == (1 + 1 + 2) / 2


def test_a_range_with_no_kernels_reads_zero():
    events = canned() + [ev(A, "pano.compose.context", 81, 2)]
    assert READ(make(events)) == 0


def test_nothing_without_the_device_or_the_range():
    host_only = [e for e in canned() + [ev(A, "pano.compose.context", 72, 3)]
                 if e["cat"] not in ("kernel", "gpu_memcpy", "gpu_memset")]
    assert READ(make(host_only)) is None
    assert READ(make()) is None
