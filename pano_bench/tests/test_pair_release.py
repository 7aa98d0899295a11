"""The pair_release loop (``loops/pair_release.py``) drops each panorama
before it asks for the next: a weak reference to panorama i is dead when
call i + 1 starts, with and without the sample's copy. pair_serial, the
loop it replaces for the rotating pair, holds panorama i through call
i + 1, so that a window's peak held two neighbouring canvases, and which
two was the seed's order."""

import weakref

import pytest
import torch

from pano_bench import drivers
from pano_bench.run import make_sample, merged, pano_config
from pano_bench.spec import Spec
from pano_bench.tests.small import SEED, overrides

SPEC = Spec()
CELL = "rotate4k.device_serial"


def _run():
    cell = SPEC.workload(CELL)
    over = overrides(CELL)
    cfg = merged(SPEC.config(cell["config"]), over["config"])
    traffic = merged(SPEC.traffic(cell["traffic"]), over["traffic"])
    traffic["scenes"] = traffic["scenes"][:2]
    pool = SPEC.pool(traffic, cfg, SEED, torch.device("cpu"))
    run = drivers.Run(pano_config(cfg["pano_config"]), traffic, pool,
                      [torch.device("cpu")])
    return run, cfg


@pytest.mark.parametrize("sampled", [False, True], ids=["plain", "sampled"])
@pytest.mark.parametrize("driver", ["pair_release", "pair_serial"])
def test_previous_panorama_is_dead_before_the_next_call(monkeypatch, driver,
                                                        sampled):
    from pano_tpu_torch.pipeline import PairStitcher

    run, cfg = _run()
    real = PairStitcher.stitch_pair_fast
    refs, alive_at_call = [], []

    def call(self, left, right):
        alive_at_call.append(bool(refs) and refs[-1]() is not None)
        pano = real(self, left, right)
        refs.append(weakref.ref(pano))
        return pano
    monkeypatch.setattr(PairStitcher, "stitch_pair_fast", call)
    make, _ = drivers.loop_of(driver, SPEC)
    loop = make(run)
    sample = make_sample(SEED, run.pool, cfg, 2, False) if sampled \
        else drivers.NO_SAMPLE
    answers = loop(drivers.count(4), sample)
    assert len(answers) == 4 and len(alive_at_call) == 4
    if driver == "pair_release":
        assert not any(alive_at_call)
        assert all(r() is None for r in refs)
    else:
        assert alive_at_call == [False, True, True, True]
    kept = [a["pano"] for a in answers if a["pano"] is not None]
    assert len(kept) == (2 if sampled else 0)
