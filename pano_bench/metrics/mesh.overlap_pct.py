"""Share of the window in which two or more of the cell's cards are
busy at once."""


def read(t):
    if len(t.devices) < 2 or not t.device:
        return None
    return 100.0 * t.overlap_us(2) / t.window_us
