"""The port's I/O (`ya_vo_tpu_torch/io/`) against the JAX package's
(`ya_vo_tpu/io/`): KITTI calibration, pose files, image trees (.npy, and
PNG through PIL or the native decoder) and the trajectory round trip,
exactly; the prefetch iterator's order and error passing; the native PNG
decoder of both packages on gray, RGB, RGBA and corrupt files."""

import os

import numpy as np
import pytest

from ya_vo_tpu.io import kitti as jkitti
from ya_vo_tpu.io import native_loader as jnative
from ya_vo_tpu_torch.io import kitti as tkitti
from ya_vo_tpu_torch.io import native_loader as tnative
from ya_vo_tpu_torch.io.prefetch import PrefetchIterator

CALIB = ("P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
         "0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 "
         "1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 "
         "0.000000000000e+00 1.000000000000e+00 0.000000000000e+00\n"
         "P1: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
         "-3.861448000000e+02 0.000000000000e+00 7.188560000000e+02 "
         "1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 "
         "0.000000000000e+00 1.000000000000e+00 0.000000000000e+00\n")


def _poses(n=9, seed=0):
    """Seeded camera->world poses [n, 4, 4]: a slow yaw and forward steps."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.cumsum(rng.normal(0, 0.02, n))
    out[:, 0, 0] = out[:, 2, 2] = np.cos(yaw)
    out[:, 0, 2], out[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    out[:, :3, 3] = np.cumsum(rng.normal([0, 0, 0.8], 0.05, (n, 3)), 0)
    return out


def _tree(base, kind, rng, n=4, size=(30, 50)):
    """A sequence 05 of `n` seeded frames as `kind` files (npy or png),
    written out of order beside a stray file the listing must skip, with
    calib.txt and poses/05.txt."""
    from PIL import Image

    d = base / "sequences" / "05" / "image_0"
    os.makedirs(d)
    (d / "notes.txt").write_text("not a frame")
    frames = rng.integers(0, 255, (n,) + size, dtype=np.uint8)
    for i, f in enumerate(frames[::-1]):       # written out of order
        name = str(d / f"{n - 1 - i:06d}")
        if kind == "png":
            Image.fromarray(f, "L").save(name + ".png")
        else:
            np.save(name + ".npy", f)
    (base / "sequences" / "05" / "calib.txt").write_text(CALIB)
    os.makedirs(base / "poses")
    np.savetxt(base / "poses" / "05.txt",
               _poses(n)[:, :3, :4].reshape(n, 12))
    return frames


@pytest.mark.parametrize("line", [CALIB.splitlines()[1],
                                  "P2 1 2 3 4 5 6 7 8 9 10 11 12 13",
                                  "Tr: 1e-3 0 0 0 0 1 0 0 0 0 1 -2.5"])
def test_parse_calib_line_equal(line):
    np.testing.assert_array_equal(tkitti.parse_calib_line(line),
                                  jkitti.parse_calib_line(line))
    with pytest.raises(ValueError):
        tkitti.parse_calib_line("P0: 1 2 3")


def test_load_calib_and_camera_equal(tmp_path):
    path = tmp_path / "calib.txt"
    path.write_text(CALIB)
    t, j = tkitti.load_calib(str(path)), jkitti.load_calib(str(path))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.P, b.P)
        np.testing.assert_array_equal(a.K, b.K)
    cam_t, cam_j = t[0].camera(), j[0].camera()
    assert type(cam_t).__module__ == "ya_vo_tpu_torch.core.camera"
    assert tuple(cam_t) == tuple(float(np.asarray(c)) for c in cam_j)
    (tmp_path / "one.txt").write_text(CALIB.splitlines()[0])
    with pytest.raises(ValueError):
        tkitti.load_calib(str(tmp_path / "one.txt"))


@pytest.mark.parametrize("kind", ["npy", "png"])
def test_image_tree_equal(tmp_path, kind):
    rng = np.random.default_rng(3)
    frames = _tree(tmp_path, kind, rng)
    base = str(tmp_path)
    assert tkitti.sequence_dir(base, "05") == jkitti.sequence_dir(base, "05")
    paths = tkitti.list_images(base, "05")
    assert paths == jkitti.list_images(base, "05") and len(paths) == 4
    for p, f in zip(paths, frames):
        img = tkitti.load_image_gray(p)
        assert img.dtype == np.uint8
        np.testing.assert_array_equal(img, jkitti.load_image_gray(p))
        np.testing.assert_array_equal(img, f)
    for prefetch in (0, 2):
        t = list(tkitti.ImageStream(base, "05", prefetch=prefetch))
        j = list(jkitti.ImageStream(base, "05", prefetch=prefetch))
        assert len(tkitti.ImageStream(base, "05")) == len(t) == len(j) == 4
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_rgb_npy_frames_equal(tmp_path):
    """A colour .npy frame is averaged to gray the same way."""
    rgb = np.random.default_rng(5).integers(0, 255, (20, 30, 3), np.uint8)
    np.save(tmp_path / "c.npy", rgb)
    p = str(tmp_path / "c.npy")
    np.testing.assert_array_equal(tkitti.load_image_gray(p),
                                  jkitti.load_image_gray(p))


def test_pose_files_and_trajectory_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    _tree(tmp_path, "npy", rng, n=6)
    base = str(tmp_path)
    t, j = tkitti.load_gt_poses(base, "05"), jkitti.load_gt_poses(base, "05")
    assert t.shape == (6, 4, 4)
    np.testing.assert_array_equal(t, j)
    assert tkitti.load_gt_poses(base, "99") is None
    cw = _poses(9, seed=2)
    tkitti.save_trajectory_kitti(str(tmp_path / "t.txt"), cw)
    jkitti.save_trajectory_kitti(str(tmp_path / "j.txt"), cw)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    back = tkitti.load_poses(str(tmp_path / "t.txt"))
    np.testing.assert_array_equal(back, jkitti.load_poses(
        str(tmp_path / "j.txt")))
    np.testing.assert_allclose(back, cw, atol=1e-8)


def test_prefetch_iterator_order_and_errors():
    items = list(range(20))
    assert list(PrefetchIterator(items, lambda x: x * 2, depth=3)) \
        == [x * 2 for x in items]

    def boom(x):
        if x == 3:
            raise RuntimeError("decode failed")
        return x

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for v in PrefetchIterator(range(10), boom, depth=2):
            got.append(v)
    assert got == [0, 1, 2]
    it = PrefetchIterator(range(100), lambda x: x, depth=2)
    assert next(it) == 0
    it.close()


def _png(tmp_path, arr, mode, name):
    from PIL import Image

    p = str(tmp_path / name)
    Image.fromarray(arr, mode).save(p)
    return p


@pytest.mark.parametrize("mode,shape", [
    ("L", (123, 251)), ("RGB", (60, 80, 3)), ("RGBA", (30, 40, 4)),
    ("L", (376, 1241))])
def test_native_decode_equal(tmp_path, mode, shape):
    """The port's decoder gives the JAX package's bytes (the luma of a
    colour PNG included); where the native library is built, gray PNGs
    decode to their pixels exactly."""
    arr = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)
    p = _png(tmp_path, arr, mode, "f.png")
    t, j = tnative.decode_png_gray(p), jnative.decode_png_gray(p)
    assert tnative.available() == jnative.available()
    if j is None:
        assert t is None
        return
    np.testing.assert_array_equal(t, j)
    if mode == "L":
        np.testing.assert_array_equal(t, arr)


def test_native_decode_corrupt(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all")
    trunc = tmp_path / "trunc.png"
    trunc.write_bytes(bytes([137, 80, 78, 71, 13, 10, 26, 10, 0, 0]))
    for p in (bad, trunc):
        assert tnative.decode_png_gray(str(p)) is None
        assert jnative.decode_png_gray(str(p)) is None
