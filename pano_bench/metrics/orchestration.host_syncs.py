"""The host's blocks on the card a panorama: the program's outermost
``pano.wait`` ranges (the pair's row event, the chain's stacked rows and
its panorama's fetch), per panorama. Nothing where the trace holds no
range of the program."""


def read(t):
    if not t.program or not t.counts["panoramas"]:
        return None
    return t.program_count("wait") / t.counts["panoramas"]
