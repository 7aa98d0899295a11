"""The direct alignment's share of its roofline: the least time of its
passes (``align_roofline.py``: each pair's overlap from its planted
geometry, left by the loop as ``align.least_us=<us>`` spans, one a
panorama, ``loops/pair_release.py``), over the device time of its kernel
(K11, ``align_gauss_newton_kernel``), in the window. Nothing where either
is missing."""

KERNEL = "align_gauss_newton_kernel"
LEAST = "align.least_us="


def read(t):
    least = sum(float(name[len(LEAST):]) for name, *_ in t.spans
                if name.startswith(LEAST))
    lo, hi = t.window
    us = sum(min(d["end"], hi) - max(d["start"], lo) for d in t.device
             if d["cat"] == "kernel" and d["base"] == KERNEL)
    if not least or not us:
        return None
    return 100.0 * least / us
