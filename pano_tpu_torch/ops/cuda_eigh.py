"""K7: the smallest eigenvector of a symmetric 9x9 matrix
(``csrc/eigh9.cu``) and its plain version.

Replaces the ``jnp.linalg.eigh`` of the refine in
``pano_tpu/ops/ransac.py::refine_homography``, which XLA's TPU lowering
runs on the device as Jacobi sweeps. torch has no ``eigh`` that leaves
the host alone (``torch.linalg.eigh`` reads its error code on the host),
so the port's refine takes this kernel: the fused estimate then runs from
detection to its row with no host sync.

The method is a cyclic Jacobi method in round-robin order. The input and
the result are f32, as the JAX package's ``eigh``; the rotations are f64
and the vector is rounded to f32 once, at the end (f32 rotations left it
a few units in the last place from the exact vector, enough to move a
canvas edge that lies on an integer to the other side of the JAX
package's: ``tests/test_torch_pipeline.py``'s translated pair). The 9
indices padded to 10 give 9 rounds of 5 disjoint rotations (the circle
method: round r pairs (r, 9) and ((r + k) % 9, (r - k) % 9) for k =
1..4; the pad's row and column stay zero, so its rotations are
skipped). Each round takes its five rotations from the matrix before
it, applies them to the columns of A and V, then to the rows of A, and
sets the pivots' diagonal entries to a_pp - t a_pq and a_qq + t a_pq and
their off-diagonal entries to zero. A rotation whose a_pq is exactly
zero is skipped. After a fixed number of sweeps the result is the column
of V at the smallest diagonal entry (torch.argmin's choice: the first
minimum, a NaN first). The sign is left as it falls: the refine divides
by h[2, 2].

``smallest_eigvec9`` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor; any other device raises. The plain
version repeats the kernel's arithmetic operation for operation, so that
the two are equal bit for bit on the card (with ``-fmad=false``).
"""

from __future__ import annotations

import functools

import torch

from pano_tpu_torch import _build

# Kernel launches since the last reset: tests and chip_smoke.py read it to
# prove that the kernel path ran. A replay of RANSAC's CUDA graph adds the
# launches the graph holds (ops/ransac.py). It is not tracing; the
# profiler's spans (timer.span) are.
launches = 0

# Fixed, so that nothing is read on the host: the refine's matrices and
# random SPD ones reach the f64 floor in 5-6 sweeps
# (tests/test_torch_eigh.py).
SWEEPS = 8
# Above this |theta|, t = 1 / (2 theta) takes the place of 1 / (|theta| +
# sqrt(theta^2 + 1)), equal to f64 precision there: theta^2 overflows f64
# from ~1e154, and an f32 input can give |theta| up to ~1e83.
_BIG = 1e18


def rounds():
    """The 9 rounds of 5 disjoint (p, q) pairs over the padded indices
    0..9 (csrc/eigh9.cu computes the same pairs)."""
    return [[(r, 9)] + [((r + k) % 9, (r - k) % 9) for k in range(1, 5)]
            for r in range(9)]


@functools.lru_cache(maxsize=None)
def _frames(device: torch.device):
    """The plain version keeps A (10x10) and V in the current round's
    frame, where its pairs are (k, k + 5): frame index i is the original
    index frame[i]. Returns the index into the first frame, the
    permutation from each round's frame to the next round's, and the
    index from the first frame back to the original order (a sweep of
    nine rounds ends in the first frame)."""
    frames = [[p for p, _ in rs] + [q for _, q in rs] for rs in rounds()]
    steps = [[frames[r].index(j) for j in frames[(r + 1) % 9]]
             for r in range(9)]
    back = [frames[0].index(j) for j in range(10)]

    def t(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    return t(frames[0]), [t(s) for s in steps], t(back)


def smallest_eigvec9_plain(ata: torch.Tensor, sweeps: int = SWEEPS
                           ) -> torch.Tensor:
    """(9,) f32: the eigenvector of the symmetric (9, 9) f32 `ata` at its
    smallest eigenvalue, by the kernel's Jacobi rounds in f64, each
    round's five rotations as one vector operation."""
    first, steps, back = _frames(ata.device)
    a = torch.zeros((10, 10), dtype=torch.float64, device=ata.device)
    a[:9, :9] = ata
    a = a[first][:, first]
    v = torch.eye(10, dtype=torch.float64, device=ata.device)[:, first]
    for _ in range(sweeps):
        for step in steps:
            app = a.diagonal()[:5]
            aqq = a.diagonal()[5:]
            apq = a[:5, 5:].diagonal()
            theta = (aqq - app) / (apq * 2.0)
            at = theta.abs()
            t = torch.reciprocal(at + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta < 0, -t, t)
            t = torch.where(at > _BIG, torch.reciprocal(theta) * 0.5, t)
            t = torch.where(apq == 0, 0.0, t)
            c = torch.reciprocal(torch.sqrt(t * t + 1.0))
            s = t * c
            # columns of A and V: (A J, V J)
            m = torch.cat([a, v])
            mp, mq = m[:, :5], m[:, 5:]
            m = torch.cat([c * mp - s * mq, s * mp + c * mq], 1)
            # rows of A: J^T (A J)
            rp, rq = m[:5], m[5:10]
            c1, s1 = c[:, None], s[:, None]
            new_a = torch.cat([c1 * rp - s1 * rq, s1 * rp + c1 * rq])
            ta = t * apq
            new_a.diagonal().copy_(torch.cat([app - ta, aqq + ta]))
            new_a[:5, 5:].diagonal().zero_()
            new_a[5:, :5].diagonal().zero_()
            # into the next round's frame
            a = new_a[step][:, step]
            v = m[10:, step]
    d = a.diagonal()[back][:9]
    j = torch.argmin(d)
    return v[:9, back].index_select(1, j.reshape(1))[:, 0].float()


def smallest_eigvec9(ata: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the symmetric (9, 9) f32 `ata` at its smallest
    eigenvalue, (9,) f32 on ata's device; see ``smallest_eigvec9_plain``.
    On the GPU one launch, with no host sync."""
    if ata.dtype != torch.float32 or ata.shape != (9, 9):
        raise ValueError(
            f"smallest_eigvec9: want a (9, 9) float32 matrix, got "
            f"{tuple(ata.shape)} {ata.dtype}")
    if ata.device.type == "cpu":
        return smallest_eigvec9_plain(ata)
    if ata.device.type != "cuda":
        raise ValueError(f"smallest_eigvec9: unsupported device {ata.device}")
    ata = ata.contiguous()
    out = torch.empty(9, dtype=torch.float32, device=ata.device)
    global launches
    _build.launch("pano_smallest_eigvec9", ata.device, ata.data_ptr(),
                  out.data_ptr(), SWEEPS)
    launches += 1
    return out
