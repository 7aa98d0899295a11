"""Scenes with planted geometry, made from the seed.

Every panorama of the benchmark is a set of crops of one textured scene
at planted offsets, so its truth is known without the code under test:
image i lies at ``offsets[i]`` (x, y) in the scene, so the homography
that places it in image 0's frame is the translation
``offsets[i] - offsets[0]``, and the panorama is the scene over the
union of the crops.

The texture is noise (0..59 per channel) under bright 6x6 squares
(60..254), one square per 150 pixels: Harris finds the squares' corners
and the 5x5 patches around them are distinct. It is drawn on the
device in a few bulk calls; where squares overlap, the one drawn last
wins, as if they were painted in order.

The traffic fixes the set of offsets; the seed draws the textures and
the order in which the pool holds the scenes, so that every seed gives
the same set of sizes.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

SQUARE = 6
PIXELS_PER_SQUARE = 150
NOISE_MAX = 60              # noise values 0..59
SQUARE_LOW, SQUARE_HIGH = 60, 255   # square colours 60..254


class Scene(NamedTuple):
    images: list            # (h, w, 3) uint8 BGR: tensors, or numpy on the host
    offsets: Tuple[Tuple[int, int], ...]   # each image's (x, y) in the scene


def texture(h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """An (h, w, 3) uint8 texture drawn with `gen` on `device`."""
    img = torch.randint(0, NOISE_MAX, (h * w, 3), generator=gen,
                        device=device, dtype=torch.uint8)
    n = max(60, h * w // PIXELS_PER_SQUARE)
    ys = torch.randint(2, h - 10, (n,), generator=gen, device=device)
    xs = torch.randint(2, w - 10, (n,), generator=gen, device=device)
    cols = torch.randint(SQUARE_LOW, SQUARE_HIGH, (n, 3), generator=gen,
                         device=device, dtype=torch.uint8)
    d = torch.arange(SQUARE, device=device)
    flat = ((ys[:, None, None] + d[None, :, None]) * w
            + xs[:, None, None] + d[None, None, :]).reshape(-1)
    ids = torch.arange(n, device=device).repeat_interleave(SQUARE * SQUARE)
    winner = torch.full((h * w,), -1, dtype=torch.int64, device=device)
    winner.scatter_reduce_(0, flat, ids, reduce="amax")
    hit = winner >= 0
    img[hit] = cols[winner[hit]]
    return img.reshape(h, w, 3)


def scene_images(offsets: Sequence[Tuple[int, int]], h: int, w: int,
                 gen: torch.Generator, device) -> List[torch.Tensor]:
    """Crops (h, w) of one texture at `offsets`, contiguous on `device`."""
    x0 = min(x for x, _ in offsets)
    y0 = min(y for _, y in offsets)
    sh = h + max(y for _, y in offsets) - y0
    sw = w + max(x for x, _ in offsets) - x0
    tex = texture(sh, sw, gen, device)
    return [tex[y - y0:y - y0 + h, x - x0:x - x0 + w].contiguous()
            for x, y in offsets]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def make_pool(scenes: Sequence[Sequence[Sequence[int]]], h: int, w: int,
              seed: int, device, resident: str) -> List[Scene]:
    """The pool: the traffic's `scenes` (each a list of (x, y) offsets)
    in an order drawn from `seed`, each with its own texture. `resident`
    is "device" (tensors on `device`) or "host" (numpy, as a caller that
    decoded files holds them)."""
    order = list(range(len(scenes)))
    random.Random(seed).shuffle(order)
    gen = generator(seed, device)
    pool = []
    for k in order:
        offsets = tuple((int(x), int(y)) for x, y in scenes[k])
        imgs = scene_images(offsets, h, w, gen, device)
        if resident == "host":
            imgs = [t.cpu().numpy() for t in imgs]
        elif resident != "device":
            raise ValueError(f"resident must be device or host: {resident}")
        pool.append(Scene(imgs, offsets))
    return pool


def translation(x: float, y: float) -> np.ndarray:
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]])


def planted_globals(scene: Scene) -> List[np.ndarray]:
    """The homography of each image into image 0's frame."""
    (x0, y0) = scene.offsets[0]
    return [translation(x - x0, y - y0) for x, y in scene.offsets]
