"""Device ms a panorama of the direct alignment's kernel (K11,
``align_gauss_newton_kernel``), found by name: inside the estimate's CUDA
graph its passes are kernels of one graph launch. Nothing where the
device was not traced or no such kernel ran."""

KERNEL = "align_gauss_newton_kernel"


def read(t):
    lo, hi = t.window
    us = sum(min(d["end"], hi) - max(d["start"], lo) for d in t.device
             if d["cat"] == "kernel" and d["base"] == KERNEL)
    if not us or not t.counts["panoramas"]:
        return None
    return us / 1e3 / t.counts["panoramas"]
