"""Device ms a panorama of the kernels launched inside the program's
``pano.estimate`` ranges, a CUDA graph's replays included: auto mode's
match and RANSAC of every pair. Nothing where the device was not traced
or no such range ran."""


def read(t):
    if not t.device or not t.program_spans("estimate"):
        return None
    return t.program_kernel_us("estimate") / 1e3 / t.counts["panoramas"]
