"""Scenes with planted geometry, made from the seed.

Every panorama of the benchmark is a set of images of one textured
scene whose geometry the harness planted, so its truth is known without
the code under test: each scene carries the homography of each image
into image 0's frame (``planted_globals``). A traffic file picks how
its scenes are made by its "scene" key: a scene model, the file
``scene_models/<scene>.py`` (``Spec.scene_model``), which defines
``make_pool(traffic, cfg, seed, device, resident)``. Without the key the
model is ``crops``, this module's ``make_pool``: crops of one texture at
planted offsets, image i at ``offsets[i]`` (x, y) in the scene, so that
the homography that places it in image 0's frame is the translation
``offsets[i] - offsets[0]``, and the panorama is the scene over the
union of the crops.

The texture is noise (0..59 per channel) under bright 6x6 squares
(60..254), one square per 150 pixels: Harris finds the squares' corners
and the 5x5 patches around them are distinct. It is drawn on the
device in a few bulk calls; where squares overlap, the one drawn last
wins, as if they were painted in order.

The traffic fixes the geometry (here the set of offsets); the seed
draws the textures and the order in which the pool holds the scenes
(``pool_order``), so that every seed gives the same set of sizes.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

SQUARE = 6
PIXELS_PER_SQUARE = 150
NOISE_MAX = 60              # noise values 0..59
SQUARE_LOW, SQUARE_HIGH = 60, 255   # square colours 60..254


class Scene(NamedTuple):
    images: list            # (h, w, 3) uint8 BGR: tensors, or numpy on the host
    # each crop's (x, y) in the scene; None where the model plants no
    # translations
    offsets: Optional[Tuple[Tuple[int, int], ...]]
    # each image's float64 3x3 homography into image 0's frame
    planted: Tuple[np.ndarray, ...]


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


def pool_order(n: int, seed: int) -> List[int]:
    """The order, drawn from `seed`, in which a pool holds the traffic's
    `n` scenes."""
    order = list(range(n))
    random.Random(seed).shuffle(order)
    return order


def resident_images(imgs: List[torch.Tensor], resident: str) -> list:
    """`imgs` as the caller holds them: "device" (the tensors) or "host"
    (numpy, as a caller that decoded files holds them)."""
    if resident == "host":
        return [t.cpu().numpy() for t in imgs]
    if resident != "device":
        raise ValueError(f"resident must be device or host: {resident}")
    return imgs


def make_pool(scenes: Sequence[Sequence[Sequence[int]]], h: int, w: int,
              seed: int, device, resident: str) -> List[Scene]:
    """The crops model's pool: the traffic's `scenes` (each a list of
    (x, y) offsets) in an order drawn from `seed`, each with its own
    texture, on `device` or the host (`resident`)."""
    gen = generator(seed, device)
    pool = []
    for k in pool_order(len(scenes), seed):
        offsets = tuple((int(x), int(y)) for x, y in scenes[k])
        imgs = scene_images(offsets, h, w, gen, device)
        (x0, y0) = offsets[0]
        planted = tuple(translation(x - x0, y - y0) for x, y in offsets)
        pool.append(Scene(resident_images(imgs, resident), offsets, planted))
    return pool


def translation(x: float, y: float) -> np.ndarray:
    return np.array([[1.0, 0.0, x], [0.0, 1.0, y], [0.0, 0.0, 1.0]])


def planted_globals(scene: Scene) -> List[np.ndarray]:
    """The homography of each image into image 0's frame."""
    return [g.copy() for g in scene.planted]
