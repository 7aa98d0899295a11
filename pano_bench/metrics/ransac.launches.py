"""Kernel launches per estimate: the runtime's launch events inside the
``ransac_homography`` spans, per span; a CUDA graph's launch counts
once."""


def read(t):
    if not t.on_device("ransac"):
        return None
    return t.launches_in("ransac") / len(t.outermost("ransac"))
