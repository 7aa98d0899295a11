"""Cells shrunk for the CPU: small images, fewer keypoints and
hypotheses, two scenes (eight for the batched cell); every kernel runs
its plain PyTorch version."""

import torch

PAIR_SCENES = [[[0, 0], [83, 5]], [[0, 0], [97, 11]]]
CHAIN_SCENES = [[[0, 0], [83, 5], [171, 9], [251, 3]],
                [[0, 0], [79, 3], [165, 12], [249, 7]]]
PIPELINE = {"harris": {"max_keypoints": 1024},
            "ransac": {"num_iterations": 200}}

OVERRIDES = {
    "pair4k.device_serial": {
        "config": {"image_h": 256, "image_w": 320, "pano_config": PIPELINE},
        "traffic": {"scenes": PAIR_SCENES, "sample_cycles": 1,
                    "trace_panoramas": 2}},
    "pair4k.host_inflight3": {
        "config": {"image_h": 256, "image_w": 320, "pano_config": PIPELINE},
        "traffic": {"scenes": PAIR_SCENES, "sample_cycles": 1,
                    "trace_panoramas": 2}},
    "oilseed_chain.host_serial": {
        "config": {"image_h": 200, "image_w": 240, "pano_config": PIPELINE},
        "traffic": {"scenes": CHAIN_SCENES, "sample_cycles": 1,
                    "trace_panoramas": 2}},
    "pair4k.batch4_mesh4": {
        "config": {"image_h": 256, "image_w": 320, "pano_config": PIPELINE},
        "traffic": {"scenes": [[[0, 0], [83, 5]]] * 8, "sample_cycles": 1,
                    "trace_panoramas": 8}},
}

SEED = 2 ** 31 + 977   # more than 32 signed bits hold

# Cells whose traffic and drivers are here and measured, but that
# BENCHMARK.json leaves out (their runs spread too widely on a shared
# host for the largest bound; PERF.md section 7).
READY = [
    {"name": "pair4k.host_inflight3", "config": "mountain_pair_4k",
     "traffic": "host_inflight3", "chips": 1},
    {"name": "pair4k.batch4_mesh4", "config": "mountain_pair_4k",
     "traffic": "batch4_mesh4", "chips": 4},
]


def cpu_devices(cell: dict):
    return [torch.device("cpu")] * int(cell["chips"])
