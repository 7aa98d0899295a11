"""Device ms per image of the kernels launched under the detect spans
(K1 and the stable top-K)."""


def read(t):
    if not t.on_device("detect"):
        return None
    return t.kernel_us("detect") / 1e3 / t.counts["images"]
