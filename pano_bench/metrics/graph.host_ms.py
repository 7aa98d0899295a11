"""Host ms a panorama in the program's outermost ``pano.graph`` ranges:
auto mode's work on the fetched pair rows (the edge table, the spanning
tree, the bundle gate). Nothing where no such range ran."""


def read(t):
    if not t.program_spans("graph") or not t.counts["panoramas"]:
        return None
    return t.program_span_us("graph") / 1e3 / t.counts["panoramas"]
