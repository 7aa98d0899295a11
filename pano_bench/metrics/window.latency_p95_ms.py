"""``latency_p95_ms`` of the untraced window that the traced run makes
first (``run.run_cell``), reported per layer in the cells whose tail
spreads too widely on the host's clock for an end-to-end bound."""


def read(t):
    return t.timed.get("latency_p95_ms")
