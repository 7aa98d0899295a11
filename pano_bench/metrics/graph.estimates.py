"""Pair estimates a panorama: the program's outermost ``pano.estimate``
ranges (n(n - 1)/2 of them in auto mode). Nothing where no such range
ran."""


def read(t):
    n = t.program_count("estimate")
    if not n or not t.counts["panoramas"]:
        return None
    return n / t.counts["panoramas"]
