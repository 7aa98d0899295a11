"""Device ms per estimated pair of the kernels launched under the match
spans (K2 on both images, K3 and its epilogue, the match points)."""


def read(t):
    if not t.on_device("match"):
        return None
    return t.kernel_us("match") / 1e3 / t.counts["estimates"]
