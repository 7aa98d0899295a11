"""100 x (1 - busy / window), averaged over the cell's cards; busy is
the union of a card's kernel, memcpy and memset intervals over its
streams."""


def read(t):
    if not t.device or not t.devices:
        return None
    busy = sum(t.busy_us(d) for d in t.devices) / len(t.devices)
    return 100.0 * (1.0 - busy / t.window_us)
