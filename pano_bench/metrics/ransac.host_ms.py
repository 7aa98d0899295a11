"""Host ms per estimate inside ``ransac_homography``: nothing in it
waits on the card, so this is the time the host takes to enqueue it."""


def read(t):
    spans = t.outermost("ransac")
    if not spans:
        return None
    return t.span_us("ransac") / 1e3 / len(spans)
