"""K3: streaming argmin-SSD matcher (``csrc/match.cu``) and its plain
version.

Replaces ``pano_tpu/ops/pallas_match.py::match_streaming_pallas`` (body
``_kernel``, launched by ``_cores_pallas``). Both versions return the
matcher's cores: per query the best SSD, its index and the second best;
per train column the best valid query row. The plain version is the
dense one of ``_cores_xla``. What bounds the kernel on an H100, and why it
is bit-identical to the plain version, is noted at the top of
``csrc/match.cu``.

``match_cores`` takes the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import torch

from pano_tpu_torch import _build

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def match_cores_plain(desc_q, valid_q, desc_t, valid_t):
    """Dense cores: (best (Kq,), best_idx (Kq,) i32, second (Kq,),
    col_best (Kt,) i32). argmin takes the lowest index on ties."""
    q_sq = torch.sum(desc_q * desc_q, dim=1)
    t_sq = torch.sum(desc_t * desc_t, dim=1)
    dots = desc_q @ desc_t.T  # fp32 (TF32 is off, see package __init__)
    ssd = q_sq[:, None] + t_sq[None, :] - 2.0 * dots
    inf = torch.full_like(ssd, float("inf"))
    ssd = torch.where(valid_t[None, :], ssd, inf)
    best_idx = torch.argmin(ssd, dim=1)
    best = torch.gather(ssd, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(ssd.shape[1], device=ssd.device)
    second = torch.amin(
        torch.where(cols[None, :] == best_idx[:, None], inf, ssd), dim=1
    )
    col_best = torch.argmin(torch.where(valid_q[:, None], ssd, inf), dim=0)
    return best, best_idx.to(torch.int32), second, col_best.to(torch.int32)


def match_cores(desc_q, valid_q, desc_t, valid_t):
    """Matcher cores of (Kq, D) and (Kt, D) f32 descriptors whose entries
    are u8 values, with (Kq,) and (Kt,) bool validity."""
    kq, d = desc_q.shape
    kt = desc_t.shape[0]
    if desc_q.dtype != torch.float32 or desc_t.dtype != torch.float32 \
            or desc_t.shape != (kt, d):
        raise ValueError("match_cores: want (Kq, D) and (Kt, D) float32")
    if valid_q.dtype != torch.bool or valid_q.shape != (kq,) \
            or valid_t.dtype != torch.bool or valid_t.shape != (kt,):
        raise ValueError("match_cores: want (Kq,) and (Kt,) bool validity")
    devs = {desc_q.device, valid_q.device, desc_t.device, valid_t.device}
    if len(devs) != 1:
        raise ValueError(f"match_cores: tensors on several devices {devs}")
    dev = desc_q.device
    if dev.type == "cpu":
        return match_cores_plain(desc_q, valid_q, desc_t, valid_t)
    if dev.type != "cuda":
        raise ValueError(f"match_cores: unsupported device {dev}")
    if not all(x.is_contiguous() for x in (desc_q, valid_q, desc_t, valid_t)):
        raise ValueError("match_cores: inputs must be contiguous")
    if kq == 0 or kt == 0 or d == 0:
        raise ValueError(f"match_cores: empty problem {(kq, kt, d)}")
    # |q|^2 and |t|^2 are integers below 2^24: exact in any order.
    q_sq = torch.sum(desc_q * desc_q, dim=1)
    t_sq = torch.sum(desc_t * desc_t, dim=1)
    best = torch.empty(kq, dtype=torch.float32, device=dev)
    idx = torch.empty(kq, dtype=torch.int32, device=dev)
    second = torch.empty(kq, dtype=torch.float32, device=dev)
    col_key = torch.empty(kt, dtype=torch.int64, device=dev)  # scratch
    col_best = torch.empty(kt, dtype=torch.int32, device=dev)
    global launches
    _build.launch(
        "pano_match_streaming", dev,
        desc_q.data_ptr(), desc_t.data_ptr(), q_sq.data_ptr(),
        t_sq.data_ptr(), valid_q.data_ptr(), valid_t.data_ptr(),
        best.data_ptr(), idx.data_ptr(), second.data_ptr(),
        col_key.data_ptr(), col_best.data_ptr(), kq, kt, d,
    )
    launches += 1
    return best, idx, second, col_best
