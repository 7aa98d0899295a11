"""Device ms a panorama of the kernels launched inside the program's
``pano.compose.context`` ranges: the torch window work of multiband and
the gain in the global composite. Nothing where the device was not
traced or no such range ran."""


def read(t):
    if not t.device or not t.program_spans("compose.context"):
        return None
    return t.program_kernel_us("compose.context") / 1e3 \
        / t.counts["panoramas"]
