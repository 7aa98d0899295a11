#!/usr/bin/env python3
"""Time one copy of pano_tpu_torch's batched pair stitch on the GPU, for
comparing versions of ``parallel/shard.py`` in one run on one machine.

    python3 tools/torch_batched_pairs_ab.py DIR

DIR holds a ``pano_tpu_torch`` package (this checkout's, or another
version unpacked beside it, e.g. ``git archive <commit> pano_tpu_torch``);
it builds its kernels into ``DIR/build``. The data are ``chip_smoke.py``
phase 13's four same-shape pairs (the 4156x3117 strip's three adjacent
pairs and the planted pair). For a mesh of the first card (data 1, as
phase 13 runs it) and of the first card repeated 4 times, it times
``shard.stitch_pairs_batched`` (host clock around synchronizes, after
one warm-up call; median of 7) and takes its peak memory above what was
allocated before the call (``torch.cuda.max_memory_allocated``), its
host fetches (``pipeline._host_fetch`` calls) and a SHA-256 of its
canvases, read as the call returns them. It prints one JSON line. Run
the versions in turns (A, B, B, A) in one call: cards and calls differ.
"""

import hashlib
import json
import pathlib
import sys
import time


def main() -> None:
    vdir = str(pathlib.Path(sys.argv[1]).resolve())
    sys.path.insert(0, vdir)
    import numpy as np
    import torch

    import pano_tpu_torch

    if not pano_tpu_torch.__file__.startswith(vdir):
        raise SystemExit(f"imported {pano_tpu_torch.__file__}, not {vdir}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_batched_pairs_ab: no CUDA device")
    from pano_tpu_torch import DEFAULT_CONFIG, _build, pipeline
    from pano_tpu_torch.parallel import shard

    _build.lib()
    sys.path.insert(1, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke as C

    _, strip = C.synthetic_strip(0)
    left, right = C.synthetic_pair(0)
    lefts = torch.from_numpy(np.stack(strip[:3] + [left])).cuda()
    rights = torch.from_numpy(np.stack(strip[1:] + [right])).cuda()
    del strip, left, right

    fetches = []
    real_fetch = pipeline._host_fetch
    pipeline._host_fetch = lambda x: (fetches.append(1), real_fetch(x))[1]
    card = torch.device("cuda", 0)
    out = {"dir": vdir, "card": C.nvidia_smi_line()}
    for n_data in (1, 4):
        mesh = shard.make_mesh(n_data, 1, devices=[card] * n_data)

        def call():
            return shard.stitch_pairs_batched(lefts, rights, DEFAULT_CONFIG,
                                              mesh)

        call()                                  # warm-up
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fetches.clear()
        panos = call()
        n_fetches = len(fetches)
        digest = hashlib.sha256()    # before any synchronize of ours
        for p in panos:
            digest.update(np.ascontiguousarray(p).tobytes())
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**20
        walls = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"data{n_data}"] = {
            "wall_ms": float(np.median(walls)), "wall_ms_all": walls,
            "peak_mib_above_inputs": round(peak, 1),
            "fetches": n_fetches, "canvases": [p.shape for p in panos],
            "sha256": digest.hexdigest()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
