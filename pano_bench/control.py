"""The control of a cell's comparison: the plain reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place. It must come out not correct.

    python3 -m pano_bench.control --workload <cell> --seeds 11,12,13

For each seed it makes the cell's pool as a run does and answers every
scene once, as a run's sample does: the placement is the planted
homography rounded to bfloat16, and the panorama the reference drawn
with its geometry and sampling in bfloat16. ``reference.judge`` then
holds these answers against the float32 reference with the cell's
limits. One JSON line a seed: {"seed", "correct", "compared"}. The
benchmark's own runs do not run it. Without the CUDA devices the cell
asks for it exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from pano_bench import reference, scenes
from pano_bench.run import merged
from pano_bench.spec import Spec


def control_answers(pool, dtype=torch.bfloat16):
    answers = []
    for k, scene in enumerate(pool):
        truth = scenes.planted_globals(scene)
        imgs = [reference._device_image(img) for img in scene.images]
        placed = [torch.as_tensor(g).to(dtype).double().numpy()
                  for g in truth]
        answers.append({"scene": k, "placed": placed,
                        "pano": reference.panorama(imgs, truth, dtype)})
    return answers


def control_run(spec: Spec, cell: dict, seed: int, device,
                overrides: Optional[dict] = None) -> dict:
    overrides = overrides or {}
    cfg = merged(spec.config(cell["config"]), overrides.get("config"))
    traffic = merged(spec.traffic(cell["traffic"]), overrides.get("traffic"))
    pool = spec.pool(traffic, cfg, seed, device)
    judged = reference.judge(control_answers(pool), pool,
                             spec.limits(cell["config"]))
    return {"seed": seed,
            "correct": judged["failed"] == 0
            and reference.within(judged["compared"]),
            "compared": judged["compared"]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    spec = Spec()
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available():
        print("pano_bench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_run(spec, cell, seed,
                                     torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
