"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process, all
started together, and one more links the objects into a shared library
with a plain C interface, ``build/pano_tpu_torch/libpano_kernels.so`` at
the repository root, loaded with ctypes. The build runs at the first
kernel launch and again whenever a source, a header or the flags change
(a SHA-256 over all of them is kept beside the library).

Every C entry takes raw device pointers and the CUDA stream as
``void*``, launches on that stream, allocates nothing and returns
``cudaGetLastError()``; the Python wrappers allocate outputs with
``torch.empty`` and raise on a non-zero return (``check``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pano_tpu_torch"
LIB_PATH = BUILD_DIR / "libpano_kernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"

# -fmad=false: no a*b+c contraction, so the stencil and warp arithmetic
# round exactly like the plain PyTorch versions (see csrc/harris.cu). The
# matcher's products use explicit fmaf, which is exact for its integers.
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
]

_V = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (restype is always int).
SIGNATURES = {
    # img, out, h, w, k, thresh, g0, g1, g2, stream
    "pano_harris_scores": [_V, _V, _I, _I, _F, _F, _F, _F, _F, _V],
    # img, xy, border_valid, desc, h, w, k, p, d_pad, stream
    "pano_gather_patches": [_V, _V, _V, _V, _I, _I, _I, _I, _I, _V],
    # q, t, qsq, tsq, vq, vt, best, idx, second, col_key, col_best,
    # kq, kt, d, stream
    "pano_match_streaming": [
        _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _V
    ],
    # right, left, out, hr, wr, hl, wl, out_h, out_w, ty, tx,
    # wy0, wx0, wy1, wx1, m00..m22, stream
    "pano_warp_compose_overlay": (
        [_V, _V, _V] + [_I] * 12 + [_F] * 9 + [_V]
    ),
    # right, rgb, weight, hr, wr, wy0, wx0, win_h, win_w, has_alpha,
    # emit_weight, m00..m22, stream
    "pano_warp_packed": [_V, _V, _V] + [_I] * 8 + [_F] * 9 + [_V],
    # left, win_rgb, w_win, out, hl, wl, out_h, out_w, ty, tx,
    # wy0, wx0, wy1, wx1, feather, stream
    "pano_compose_canvas": [_V] * 4 + [_I] * 11 + [_V],
}

_lib = None


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "pano_tpu_torch kernels"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernels unless an up-to-date library exists; returns
    its path. Writes nvcc's output (with ptxas' register and
    shared-memory report) to ``nvcc.log`` beside it."""
    digest = _digest()
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if (
        not force and LIB_PATH.exists() and stamp.exists()
        and stamp.read_text().strip() == digest
    ):
        return LIB_PATH
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [pathlib.Path(work) / (src.stem + ".o") for src in cu]
        jobs = []
        for src, obj in zip(cu, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{out}")
        if not failed:
            # Link into a temporary name, then rename: a concurrent loader
            # never sees a half-written library.
            tmp = pathlib.Path(work) / LIB_PATH.name
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n"
                              f"{proc.stdout}")
        LOG_PATH.write_text("".join(log))
        if failed:
            raise RuntimeError("\n".join(failed))
        os.replace(tmp, LIB_PATH)
    stamp.write_text(digest + "\n")
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pano_error_string.argtypes = [ctypes.c_int]
        handle.pano_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry `name` with `args` plus the current CUDA stream of
    `device`, with that device current, and raise on a CUDA error."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), name)(*args, stream)
    check(err, name)


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        text = lib().pano_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")
