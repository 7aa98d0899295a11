"""crops: each scene is crops of one seeded texture at integer offsets,
so that every image is placed in image 0's frame by a translation
(``scenes.make_pool``). The model of a traffic file that names none.

Traffic: "scenes", each a list of the images' (x, y) offsets in the
scene, in hand-over order. Configuration: "image_h", "image_w".
"""

from pano_bench import scenes


def make_pool(traffic: dict, cfg: dict, seed: int, device, resident: str):
    return scenes.make_pool(traffic["scenes"], cfg["image_h"],
                            cfg["image_w"], seed, device, resident)
