"""Launch events a panorama that ran the direct alignment's kernel (K11,
``align_gauss_newton_kernel``): the distinct correlation ids of its
kernel events. A CUDA graph's launch counts once, however many passes
it holds; launched eagerly, each pass counts. Nothing where the device
was not traced or no such kernel ran."""

KERNEL = "align_gauss_newton_kernel"


def read(t):
    launches = {d["corr"] for d in t.device
                if d["cat"] == "kernel" and d["base"] == KERNEL}
    if not launches or not t.counts["panoramas"]:
        return None
    return len(launches) / t.counts["panoramas"]
