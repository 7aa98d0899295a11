"""Kernels a panorama launched inside the program's
``pano.compose.context`` ranges: the device's kernel events whose launch
a such range holds (multiband's pyramid and the gain's window work in
the global composite), over the window's panoramas. Nothing where the
device was not traced or no such range ran."""


def read(t):
    if not t.device or not t.program_spans("compose.context"):
        return None
    n = sum(1 for d in t.device
            if d["cat"] == "kernel" and "compose.context" in d["program"])
    return n / t.counts["panoramas"]
