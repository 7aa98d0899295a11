"""Host ms a panorama inside the program's outermost ``pano.upload``
ranges: the blocking copies of host images to the card. Nothing where
the trace holds no range of the program."""


def read(t):
    if not t.program or not t.counts["panoramas"]:
        return None
    return t.program_span_us("upload") / 1e3 / t.counts["panoramas"]
