"""Device ms per panorama of the copies between host and card, both
ways (uploads of host images, the estimate rows, the panorama's
fetch), from the trace's memcpy events."""


def read(t):
    if not t.on_device("orchestration"):
        return None
    return t.memcpy_us() / 1e3 / t.counts["panoramas"]
