"""Host ms per panorama of the entry calls (the orchestration spans the
drivers open), minus the host time that the layer spans inside them
cover: the pipeline's own Python between the layers."""


def read(t):
    if not t.layer_spans("orchestration") or not t.counts["panoramas"]:
        return None
    return t.self_us("orchestration") / 1e3 / t.counts["panoramas"]
