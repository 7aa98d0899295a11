"""Device ms per panorama of the kernels launched under the compose
spans (the pair's compose, the global composite, the batched
composites): K4a, K4b, K5, K6 and the window context's torch kernels."""


def read(t):
    if not t.on_device("compose"):
        return None
    return t.kernel_us("compose") / 1e3 / t.counts["panoramas"]
