"""pano_tpu_torch one-pass composite (K5's plain version) vs the JAX
package's Pallas compose kernel in interpret mode (tile-aligned offsets,
the cases of tests/test_pallas_compose.py) and vs its XLA epilogue
``blend_window_outputs`` (unaligned offsets), on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from pano_tpu.ops import pallas_compose as PC  # noqa: E402
from pano_tpu.ops import warp as JW  # noqa: E402
from pano_tpu_torch.ops import cuda_compose  # noqa: E402

# (hl, wl, (win_h, win_w), ty, tx, wy0, wx0, (pad_h, pad_w)), from
# tests/test_pallas_compose.py:42-49: ragged left sizes, window at the
# origin / interior / flush against the canvas edge.
ALIGNED = [
    (100, 200, (128, 256), 0, 0, 0, 0, (256, 512)),
    (130, 140, (128, 256), 128, 256, 0, 256, (384, 512)),
    (128, 128, (256, 256), 0, 256, 128, 256, (384, 512)),
    (250, 120, (128, 256), 128, 0, 256, 0, (384, 512)),
]
# Unaligned placements and windows, one reaching the canvas's far corner.
UNALIGNED = [
    (101, 157, (77, 93), 13, 29, 5, 41, (170, 230)),
    (90, 60, (120, 150), 37, 3, 50, 80, (170, 230)),
]


def _case(seed, hl, wl, win_h, win_w):
    """Random left, a warped window with black (uncovered) holes, and its
    weight, as numpy: (left u8, packed i32 window, (h, w, 3) u8, f32)."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 255, (hl, wl, 3), np.uint8)
    rgb = rng.integers(0, 2**24, (win_h, win_w), np.int64).astype(np.int32)
    hole = rng.random((win_h, win_w)) < 0.3
    rgb = np.where(hole, 0, rgb)
    w = np.where(hole, 0.0, rng.random((win_h, win_w))).astype(np.float32)
    hwc = np.stack([(rgb >> s) & 0xFF for s in (0, 8, 16)], -1)
    return left, rgb, hwc.astype(np.uint8), w


def _port(left, hwc, w, ty, tx, window, pad, blend):
    return cuda_compose.compose_canvas(
        torch.from_numpy(left), torch.from_numpy(hwc),
        torch.from_numpy(w) if blend == "feather" else None,
        ty, tx, window, pad[0], pad[1], blend,
    ).numpy()


def _check(got, want, blend):
    assert got.shape == want.shape
    if blend == "overlay":
        np.testing.assert_array_equal(got, want)
    else:
        # Same math, another contraction order on the JAX side: +-1.
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() < 0.02


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("idx", range(len(ALIGNED)))
def test_plain_matches_pallas_compose_canvas(blend, idx):
    """JAX compose_canvas in interpret mode: overlay bit-exact, feather
    max |d| <= 1 (tests/test_pallas_compose.py's bar)."""
    hl, wl, (win_h, win_w), ty, tx, wy0, wx0, pad = ALIGNED[idx]
    left, rgb, hwc, w = _case(1000 * idx + (7 if blend == "feather" else 0),
                              hl, wl, win_h, win_w)
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(PC.compose_canvas(
            jnp.asarray(left), jnp.asarray(rgb),
            jnp.asarray(w) if blend == "feather" else None,
            s(ty), s(tx), s(wy0), s(wx0), pad[0], pad[1], blend,
        ))
    got = _port(left, hwc, w, ty, tx, (wy0, wx0, wy0 + win_h, wx0 + win_w),
                pad, blend)
    _check(got, want, blend)


@pytest.mark.parametrize("blend", ["overlay", "feather"])
@pytest.mark.parametrize("idx", range(len(UNALIGNED)))
def test_plain_matches_blend_window_outputs_unaligned(blend, idx):
    """JAX's XLA epilogue takes any offsets; the port's composite equals
    it at unaligned placements and windows."""
    hl, wl, (win_h, win_w), ty, tx, wy0, wx0, pad = UNALIGNED[idx]
    left, rgb, hwc, w = _case(77 + idx, hl, wl, win_h, win_w)
    s = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
    want, _ = JW.blend_window_outputs(
        jnp.asarray(left), jnp.asarray(rgb), jnp.asarray(w), s(tx), s(ty),
        s(wx0), s(wy0), pad[0], pad[1], win_h, win_w, blend,
    )
    got = _port(left, hwc, w, ty, tx, (wy0, wx0, wy0 + win_h, wx0 + win_w),
                pad, blend)
    _check(got, np.asarray(want), blend)


def test_wrapper_checks():
    left = torch.zeros((8, 8, 3), dtype=torch.uint8)
    win = torch.zeros((4, 4, 3), dtype=torch.uint8)
    w = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="unsupported blend"):
        cuda_compose.compose_canvas(left, win, w, 0, 0, (0, 0, 4, 4), 8, 8,
                                    "multiband")
    with pytest.raises(ValueError, match="weight"):
        cuda_compose.compose_canvas(left, win, None, 0, 0, (0, 0, 4, 4), 8,
                                    8, "feather")
    with pytest.raises(ValueError, match="does not match"):
        cuda_compose.compose_canvas(left, win, None, 0, 0, (0, 0, 4, 5), 8,
                                    8)
    with pytest.raises(ValueError, match="outside"):
        cuda_compose.compose_canvas(left, win, None, 0, 0, (6, 6, 10, 10), 8,
                                    8)
    meta = torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_compose.compose_canvas(meta, win.to("meta"), None, 0, 0,
                                    (0, 0, 4, 4), 8, 8)
