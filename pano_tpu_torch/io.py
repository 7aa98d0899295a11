"""Image loading/saving + CLI argument parsing (the reference "reader" layer).

A copy of ``pano_tpu/io.py`` (importing that module would import the JAX
package), with the same behavior, which is the reference's
src/reader/reader.cpp:14-82 / reader.hpp:8-15:

  * flags: ``--dir <D>`` (load every regular file in D), ``--out <F>``
    (default ``result.jpg``), everything else is a positional image path;
  * ``--dir`` takes precedence over positionals (reader.cpp:53-79);
  * unreadable files print a warning to stderr and are skipped
    (reader.cpp:62-65, 73-76);
  * missing args → usage on stderr + exit(-1) (reader.cpp:22-27);
  * the ``--dir`` listing is sorted (the reference's directory_iterator
    order is unspecified).

Images are HxWx3 uint8 numpy arrays in **BGR** channel order (cv::imread
convention).

Codecs, in order: OpenCV (``cv2``), else Pillow, else this module's own
numpy codec for binary PNM, which reads P6 (colour) and P5 (grey, given
back as three equal channels, as ``cv2.imread`` does) with maxval 255 and
``#`` comments in the header, and writes P6. So ``.ppm`` is the format to
use on a machine that has neither ``cv2`` nor Pillow. The JAX package's
native reader (``native/libpano_host.so``) wraps OpenCV's own codec and
is not loaded here.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

try:
    import cv2  # type: ignore

    _HAVE_CV2 = True
except ImportError:
    cv2 = None
    _HAVE_CV2 = False

try:
    from PIL import Image  # type: ignore

    _HAVE_PIL = True
except ImportError:
    Image = None
    _HAVE_PIL = False

_PNM_SPACE = b" \t\r\n\v\f"


def codec() -> str:
    """The codec this module reads and writes with: 'cv2', 'PIL' or
    'numpy-pnm'."""
    if _HAVE_CV2:
        return "cv2"
    if _HAVE_PIL:
        return "PIL"
    return "numpy-pnm"


@dataclasses.dataclass
class ImageReaderResult:
    """Mirror of reference ImageReaderResult (src/reader/reader.hpp:8-11)."""

    images: List[np.ndarray]
    output_file: str = "result.jpg"
    # Retained for diagnostics; not in the reference struct.
    paths: List[str] = dataclasses.field(default_factory=list)


def read_pnm(path: str) -> Optional[np.ndarray]:
    """A binary PNM file (P6 or P5, maxval 255) as HxWx3 uint8 BGR; None
    if the file is missing, of another kind, or short."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    magic = data[:2]
    if magic not in (b"P6", b"P5"):
        return None
    fields = []
    i = 2
    while len(fields) < 3:
        # Whitespace, and comments from '#' to the end of the line.
        start = i
        while i < len(data) and (data[i] in _PNM_SPACE or data[i] == 35):
            if data[i] == 35:
                while i < len(data) and data[i] not in b"\r\n":
                    i += 1
            else:
                i += 1
        j = i
        while j < len(data) and 48 <= data[j] <= 57:
            j += 1
        if i == start or j == i:  # tokens need whitespace between them
            return None
        fields.append(int(data[i:j]))
        i = j
    # Exactly one whitespace byte ends the header.
    if i >= len(data) or data[i] not in _PNM_SPACE:
        return None
    i += 1
    w, h, maxval = fields
    channels = 3 if magic == b"P6" else 1
    if maxval != 255 or w <= 0 or h <= 0 \
            or len(data) - i < w * h * channels:
        return None
    pix = np.frombuffer(data, np.uint8, w * h * channels, i)
    if channels == 1:
        return np.repeat(pix.reshape(h, w, 1), 3, axis=2)
    rgb = pix.reshape(h, w, 3)
    bgr = np.empty_like(rgb)
    bgr[..., 0] = rgb[..., 2]
    bgr[..., 1] = rgb[..., 1]
    bgr[..., 2] = rgb[..., 0]
    return bgr


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write an HxWx3 uint8 BGR image as binary P6 (RGB bytes)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    rgb = np.empty_like(img)
    rgb[..., 0] = img[..., 2]
    rgb[..., 1] = img[..., 1]
    rgb[..., 2] = img[..., 0]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def imread_bgr(path: str) -> Optional[np.ndarray]:
    """Load an image as HxWx3 uint8 BGR; None if unreadable (cv::imread)."""
    if _HAVE_CV2:
        return cv2.imread(path, cv2.IMREAD_COLOR)
    if _HAVE_PIL:
        try:
            with Image.open(path) as im:
                rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
            return rgb[..., ::-1].copy()
        except (OSError, ValueError):  # missing, unknown or broken file
            return None
    return read_pnm(path)


def imwrite_bgr(path: str, img: np.ndarray) -> bool:
    """Save an HxWx3 uint8 BGR image (cv::imwrite equivalent). Returns
    False where the file could not be written; raises ValueError where
    no codec can write the path's extension."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if _HAVE_CV2:
        return bool(cv2.imwrite(path, img))
    if _HAVE_PIL:
        Image.fromarray(img[..., ::-1]).save(path)
        return True
    ext = os.path.splitext(path)[1].lower()
    if ext != ".ppm":
        raise ValueError(
            f"cannot write {ext or 'a file without extension'!r}: neither "
            f"cv2 nor PIL is installed, and the numpy codec writes only .ppm"
        )
    try:
        write_ppm(path, img)
    except OSError:
        return False
    return True


def read_images_from_args(
    argv: Sequence[str],
    preloaded: Optional[dict] = None,
) -> ImageReaderResult:
    """Parse argv (excluding program name) exactly like readImagesFromArgs.

    `preloaded` maps path -> decoded BGR image (a host array or a tensor
    already on the card, or None for unreadable): the serve loop's
    decode-ahead worker fills it so a job's decode overlaps the previous
    job's device work; paths not in the dict decode here as usual.
    Semantics (warnings, skip-on-unreadable, ordering) are identical
    either way."""
    result = ImageReaderResult(images=[], output_file="result.jpg")

    def _read(path):
        if preloaded is not None and path in preloaded:
            return preloaded[path]
        return imread_bgr(path)

    file_names: List[str] = []
    dir_name = ""

    if len(argv) < 1:
        print(
            "Usage: pano [--dir directory_name] [--out output_file_name] "
            "[image1 image2 ...]",
            file=sys.stderr,
        )
        sys.exit(-1)

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--dir":
            if i + 1 < len(argv):
                i += 1
                dir_name = argv[i]
            else:
                print("Error: --dir requires a directory name", file=sys.stderr)
                sys.exit(-1)
        elif arg == "--out":
            if i + 1 < len(argv):
                i += 1
                result.output_file = argv[i]
            else:
                print("Error: --out requires an output file name", file=sys.stderr)
                sys.exit(-1)
        else:
            file_names.append(arg)
        i += 1

    if dir_name:
        if not os.path.isdir(dir_name):
            print(f"Error: {dir_name} is not a valid directory.", file=sys.stderr)
            sys.exit(-1)
        paths = sorted(
            os.path.join(dir_name, e)
            for e in os.listdir(dir_name)
            if os.path.isfile(os.path.join(dir_name, e))
        )
    else:
        paths = file_names
    for path in paths:
        img = _read(path)
        if img is None:
            print(f"Warning: Unable to open image file: {path}",
                  file=sys.stderr)
            continue
        result.images.append(img)
        result.paths.append(path)

    return result
