"""pano_tpu_torch.io against pano_tpu.io and OpenCV.

The reader's argument semantics (src/reader/reader.cpp:14-82) are held to
the JAX package's reader: the same images, output file, paths, stderr and
exit codes. The numpy PNM codec, which the port falls back to where
neither cv2 nor Pillow is installed, is held to cv2 in both directions.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from pano_tpu import io as jio
from pano_tpu_torch import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def image_dir(tmp_path):
    r = np.random.default_rng(7)
    for i, name in enumerate(["b.png", "a.png", "c.ppm"]):
        cv2.imwrite(str(tmp_path / name),
                    r.integers(0, 256, (20 + i, 31, 3), dtype=np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    return str(tmp_path)


def _read(mod, argv, capsys, preloaded=None):
    """(exit code or None, result fields, stderr) of one reader call."""
    try:
        res = mod.read_images_from_args(argv, preloaded=preloaded)
        code = None
    except SystemExit as e:
        res, code = None, e.code
    err = capsys.readouterr().err
    if res is None:
        return code, None, err
    return code, (res.images, res.output_file, res.paths), err


READER_CASES = {
    "no_args": lambda d: [],
    "dir_missing_value": lambda d: ["--dir"],
    "out_missing_value": lambda d: [os.path.join(d, "a.png"), "--out"],
    "dir_not_a_directory": lambda d: ["--dir", os.path.join(d, "nope")],
    "dir_sorted_skips_unreadable": lambda d: ["--dir", d],
    "positional_and_out": lambda d: [os.path.join(d, "c.ppm"), "--out",
                                     "pano.png", os.path.join(d, "a.png")],
    "dir_wins_over_positionals": lambda d: [os.path.join(d, "a.png"),
                                            "--dir", d, "--out", "x.jpg"],
    "unreadable_positional": lambda d: [os.path.join(d, "a.png"),
                                        os.path.join(d, "gone.png"),
                                        os.path.join(d, "notes.txt")],
}


@pytest.mark.parametrize("case", sorted(READER_CASES))
def test_reader_matches_jax(case, image_dir, capsys):
    argv = READER_CASES[case](image_dir)
    code_j, res_j, err_j = _read(jio, argv, capsys)
    code_t, res_t, err_t = _read(tio, argv, capsys)
    assert code_t == code_j
    assert err_t == err_j
    if res_j is None:
        assert res_t is None and code_t == -1
        return
    imgs_j, out_j, paths_j = res_j
    imgs_t, out_t, paths_t = res_t
    assert (out_t, paths_t) == (out_j, paths_j)
    assert len(imgs_t) == len(imgs_j) > 0
    for a, b in zip(imgs_t, imgs_j):
        np.testing.assert_array_equal(a, b)
    if case == "dir_sorted_skips_unreadable":
        assert [os.path.basename(p) for p in paths_t] == [
            "a.png", "b.png", "c.ppm"]
        assert "Warning: Unable to open image file" in err_t


def test_reader_preloaded_matches_jax(capsys):
    img = np.full((8, 8, 3), 7, np.uint8)
    argv = ["/definitely/not/a.png", "/definitely/not/b.png", "--out", "o.jpg"]
    pre = {"/definitely/not/a.png": img, "/definitely/not/b.png": None}
    got = _read(tio, argv, capsys, preloaded=pre)
    want = _read(jio, argv, capsys, preloaded=pre)
    assert got[0] == want[0] is None and got[2] == want[2]
    assert got[1][1:] == want[1][1:] == ("o.jpg", ["/definitely/not/a.png"])
    assert got[1][0][0] is img


SHAPES = [(1, 1), (3, 1), (5, 7), (17, 33), (24, 101)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ext", [".ppm", ".pgm"])
def test_read_pnm_matches_cv2(tmp_path, shape, ext):
    """cv2 writes binary P6 (.ppm) and P5 (.pgm); the numpy reader gives
    what cv2.imread(IMREAD_COLOR) gives, grey as three equal channels."""
    r = np.random.default_rng(shape[0] * 100 + shape[1])
    img = r.integers(0, 256, shape + ((3,) if ext == ".ppm" else ()),
                     dtype=np.uint8)
    p = str(tmp_path / f"x{ext}")
    assert cv2.imwrite(p, img)
    want = cv2.imread(p, cv2.IMREAD_COLOR)
    got = tio.read_pnm(p)
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("magic", [b"P6", b"P5"])
def test_read_pnm_header_comments_match_cv2(tmp_path, magic):
    r = np.random.default_rng(3)
    c = 3 if magic == b"P6" else 1
    pix = r.integers(0, 256, 5 * 7 * c, dtype=np.uint8).tobytes()
    p = str(tmp_path / "c.pnm")
    with open(p, "wb") as f:
        f.write(magic + b"\n# made by hand\n7 # width\n5\n#\n255\n" + pix)
    want = cv2.imread(p, cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(tio.read_pnm(p), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_write_ppm_read_by_cv2_and_round_trip(tmp_path, shape):
    r = np.random.default_rng(shape[1])
    img = r.integers(0, 256, shape + (3,), dtype=np.uint8)
    p = str(tmp_path / "w.ppm")
    tio.write_ppm(p, img)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_COLOR), img)
    np.testing.assert_array_equal(tio.read_pnm(p), img)
    with open(p, "rb") as f:
        assert f.read(2) == b"P6"


@pytest.mark.parametrize("data", [
    b"P6\n2 2\n65535\n" + bytes(24),      # 16-bit samples
    b"P6\n2 2\n15\n" + bytes(12),         # another maxval
    b"P6\n2 2\n255\n" + bytes(11),        # short
    b"P3\n1 1\n255\n0 0 0\n",             # ASCII
    b"P6\n2\n",                           # header cut
    b"P62 2\n255\n" + bytes(12),          # no space after the magic
    b"\x89PNG\r\n\x1a\n",
])
def test_read_pnm_refuses_other_files(tmp_path, data):
    p = tmp_path / "bad.ppm"
    p.write_bytes(data)
    assert tio.read_pnm(str(p)) is None
    assert tio.read_pnm(str(tmp_path / "missing.ppm")) is None


@pytest.fixture
def numpy_codec(monkeypatch):
    monkeypatch.setattr(tio, "_HAVE_CV2", False)
    monkeypatch.setattr(tio, "_HAVE_PIL", False)
    assert tio.codec() == "numpy-pnm"


def test_numpy_codec_reads_and_writes_ppm(numpy_codec, tmp_path, capsys):
    img = np.random.default_rng(5).integers(0, 256, (9, 13, 3), np.uint8)
    p = str(tmp_path / "n.ppm")
    assert tio.imwrite_bgr(p, img)
    np.testing.assert_array_equal(tio.imread_bgr(p), img)
    np.testing.assert_array_equal(cv2.imread(p), img)
    # A PNG is unreadable here: the reader warns and skips it.
    cv2.imwrite(str(tmp_path / "m.png"), img)
    res = tio.read_images_from_args(["--dir", str(tmp_path)])
    assert [os.path.basename(q) for q in res.paths] == ["n.ppm"]
    assert "Unable to open image file" in capsys.readouterr().err
    # A path that cannot be written is reported, not claimed.
    assert tio.imwrite_bgr(str(tmp_path / "no_dir" / "x.ppm"), img) is False


@pytest.mark.parametrize("name", ["x.jpg", "x.png", "x.pgm", "x"])
def test_numpy_codec_refuses_other_extensions(numpy_codec, tmp_path, name):
    img = np.zeros((4, 4, 3), np.uint8)
    ext = os.path.splitext(name)[1]
    with pytest.raises(ValueError, match=repr(ext) if ext else "extension"):
        tio.imwrite_bgr(str(tmp_path / name), img)
    assert not os.path.exists(tmp_path / name)


def test_imports_and_codes_without_cv2_and_pil(tmp_path):
    """With cv2 and PIL unimportable, io (and the CLI above it) import and
    round-trip a .ppm through the numpy codec."""
    code = (
        "import sys; sys.modules['cv2'] = None; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "import pano_tpu_torch.cli\n"
        "from pano_tpu_torch import io\n"
        "assert io.codec() == 'numpy-pnm', io.codec()\n"
        "img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)\n"
        f"p = {str(tmp_path / 'r.ppm')!r}\n"
        "assert io.imwrite_bgr(p, img)\n"
        "assert np.array_equal(io.imread_bgr(p), img)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr
