"""``oilseed_auto.host_serial`` at its CPU size: an answer altered where
auto mode produces it turns ``correct`` false. (``test_runs.py``'s
``test_estimate_altered`` alters ``pipeline.estimate_row``, which the
loops of ``drivers.DRIVERS`` call and auto mode does not: it estimates
each pair from cached features through ``pipeline.auto_pair_row``. This
is that test for the auto cell.)"""

import time

import torch

from pano_bench.run import run_cell
from pano_bench.spec import Spec
from pano_bench.tests.small import SEED, overrides

CELL = "oilseed_auto.host_serial"


def test_auto_estimate_altered(monkeypatch):
    """Every pair's estimate row with its x translation 2 px off."""
    from pano_tpu_torch import pipeline
    real = pipeline.auto_pair_row

    def row(*args, **kwargs):
        r = real(*args, **kwargs)
        return r + torch.nn.functional.one_hot(
            torch.tensor(2), r.shape[0]).to(r) * 2.0
    monkeypatch.setattr(pipeline, "auto_pair_row", row)
    spec = Spec()
    out = run_cell(spec, spec.workload(CELL), SEED, 0.3, False,
                   [torch.device("cpu")], time.perf_counter(),
                   overrides(CELL))
    assert not out["correct"]
    assert out["compared"]["h_err_px"]["value"] >= 1.5
