"""The PyTorch port's io/ against the JAX package's, on the CPU: the
calibration files (the reference's four pickles and the npz) and the
cameras built from them, the native PNG/PGM/PPM decoder and prefetching
frame loader (each port builds its own copy of frameloader.cpp with g++)
on files written here, and the KITTI loader on a small KITTI-shaped tree.
Cases follow tests/test_io_utils.py and tests/test_native_loader.py. Every
comparison is exact: the same files give the same arrays."""

import dataclasses
import pickle

import cv2
import numpy as np
import pytest
import torch

import openvo_tpu
from openvo_tpu.io import calib as jcalib
from openvo_tpu.io import kitti as jkitti
from openvo_tpu.io import native_loader as jloader
from openvo_tpu.io.synthetic import make_rig
from openvo_tpu_torch import StereoCamera
from openvo_tpu_torch.io import calib, kitti, native_loader

SGBM = {
    "minDisparity": 0, "numDisparities": 64, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
IMG_SIZE = (256, 192)


def rig():
    K, dist, R, T = make_rig(IMG_SIZE)
    dist = np.array([0.05, -0.01, 0.001, 0.0, 0.0])   # a distorting camera
    return K, dist, R, T


def assert_cameras_equal(cam, jcam):
    """The port's camera and JAX's from the same calibration: the same
    rectification, Q, ROIs, crop, SGBM parameters and maps."""
    for a in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_array_equal(getattr(cam, a), getattr(jcam, a))
    assert cam.valid_region_left == jcam.valid_region_left
    assert cam.valid_region_right == jcam.valid_region_right
    assert cam.cropped_shape == jcam.cropped_shape
    assert dataclasses.asdict(cam.sgbm) == dataclasses.asdict(jcam.sgbm)
    for got, want in zip(cam.map_left + cam.map_right,
                         jcam.map_left + jcam.map_right):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_from_pfiles_roundtrip(tmp_path, writer):
    """Pickles written by either package load into equal cameras."""
    K, dist, R, T = rig()
    save = calib.save_pfiles if writer == "port" else jcalib.save_pfiles
    paths = save(str(tmp_path / "cal"), K, dist, K, dist, R, T, SGBM)
    args = (paths["left"], paths["right"], paths["rect"], paths["sgbm"],
            IMG_SIZE)
    cam = StereoCamera.from_pfiles(*args, device="cpu")
    assert cam.device == torch.device("cpu")
    assert cam.sgbm.num_disparities == 64
    np.testing.assert_allclose(cam.Q[2, 3], K[0, 0], rtol=1e-6)
    assert_cameras_equal(cam, openvo_tpu.StereoCamera.from_pfiles(*args))


def test_save_pfiles_writes_jax_contents(tmp_path):
    K, dist, R, T = rig()
    mine = calib.save_pfiles(str(tmp_path / "a"), K, dist, K, dist, R, T,
                             SGBM)
    theirs = jcalib.save_pfiles(str(tmp_path / "b"), K, dist, K, dist, R,
                                T, SGBM)
    assert list(calib.SGBM_KEYS) == list(jcalib.SGBM_KEYS)
    for name in ("left", "right", "rect", "sgbm"):
        with open(mine[name], "rb") as f, open(theirs[name], "rb") as g:
            a, b = pickle.load(f), pickle.load(g)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_from_npz_roundtrip(tmp_path, writer):
    K, dist, R, T = rig()
    save = calib.save_npz if writer == "port" else jcalib.save_npz
    path = save(str(tmp_path / "cal.npz"), K, dist, K, dist, R, T, SGBM)
    cam = StereoCamera.from_npz(path, IMG_SIZE, device="cpu")
    assert cam.sgbm.block_size == 5
    assert_cameras_equal(cam, openvo_tpu.StereoCamera.from_npz(path,
                                                               IMG_SIZE))


def test_from_pfiles_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    K, dist, R, T = rig()
    paths = calib.save_pfiles(str(tmp_path / "cal"), K, dist, K, dist, R, T,
                              SGBM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StereoCamera.from_pfiles(paths["left"], paths["right"],
                                 paths["rect"], paths["sgbm"], IMG_SIZE)


# --- the native decoder and frame loader ----------------------------------

def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["gray", "color"])
def test_decode_png_equals_jax_and_cv2(tmp_path, kind):
    """cv2-encoded PNGs (a gradient with noise, so the encoder uses every
    scanline filter; and a color image, stored RGB)."""
    rng = np.random.default_rng(0 if kind == "gray" else 1)
    if kind == "gray":
        yy, xx = np.mgrid[0:120, 0:160]
        img = np.clip(yy + xx * 0.5 + rng.integers(0, 30, (120, 160)),
                      0, 255).astype(np.uint8)
    else:
        img = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    assert cv2.imwrite(p, img)
    got = native_loader.decode_image(read(p))
    np.testing.assert_array_equal(got, jloader.decode_image(read(p)))
    np.testing.assert_array_equal(got, img if kind == "gray"
                                  else img[..., ::-1])


def test_decode_pgm_and_ppm_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    p, q = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    native_loader.write_pgm(p, gray)
    jloader.write_pgm(q, gray)
    assert read(p) == read(q)
    for decode in (native_loader.decode_pnm, native_loader.decode_image):
        np.testing.assert_array_equal(decode(read(p)), gray)
    color = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    buf = b"P6\n# a comment\n7 5\n# another\n255\n" + color.tobytes()
    got = native_loader.decode_pnm(buf)
    np.testing.assert_array_equal(got, color)
    np.testing.assert_array_equal(got, jloader.decode_pnm(buf))


@pytest.mark.parametrize("buf", [b"JUNKJUNKJUNKJUNK", b"P5\n10 10\n255\nshort",
                                 b"\x89PNG\r\n\x1a\n" + b"\x00" * 40])
def test_decode_rejects_garbage_as_jax(buf):
    decode = (native_loader.decode_image if buf.startswith(b"\x89")
              else native_loader.decode_pnm)
    jdecode = (jloader.decode_image if buf.startswith(b"\x89")
               else jloader.decode_pnm)
    for fn in (decode, jdecode):
        with pytest.raises(ValueError):
            fn(buf)


@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_frame_loader_streams_as_jax(tmp_path, ext):
    rng = np.random.default_rng(2)
    paths, imgs = [], []
    for i in range(7):
        img = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.{ext}")
        if ext == "png":
            assert cv2.imwrite(p, img)
        else:
            native_loader.write_pgm(p, img)
        paths.append(p)
        imgs.append(img)
    loader = native_loader.FrameLoader(paths, ring_capacity=3)
    jl = jloader.FrameLoader(paths, ring_capacity=3)
    got, want = list(loader), list(jl)
    loader.close()
    jl.close()
    assert len(got) == len(want) == 7
    for a, b, c in zip(got, want, imgs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_frame_loader_bad_file_raises(tmp_path):
    p = str(tmp_path / "bad.pgm")
    with open(p, "wb") as f:
        f.write(b"not a pnm at all")
    loader = native_loader.FrameLoader([p])
    with pytest.raises(ValueError):
        next(loader)
    loader.close()


# --- KITTI -----------------------------------------------------------------

@pytest.fixture
def kitti_tree(tmp_path, monkeypatch):
    """A KITTI odometry layout with 3 gray PNG pairs, calib.txt and poses."""
    rng = np.random.default_rng(3)
    base = tmp_path / "sequences" / "00"
    for cam in ("image_0", "image_1"):
        (base / cam).mkdir(parents=True)
        for i in range(3):
            img = rng.integers(0, 256, size=(20, 30), dtype=np.uint8)
            assert cv2.imwrite(str(base / cam / f"{i:06d}.png"), img)
    P0 = np.array([[718.856, 0, 607.19, 0], [0, 718.856, 185.22, 0],
                   [0, 0, 1, 0]])
    P1 = P0.copy()
    P1[0, 3] = -386.14
    with open(base / "calib.txt", "w") as f:
        for name, P in (("P0", P0), ("P1", P1), ("P2", P0), ("P3", P1)):
            f.write(f"{name}: " + " ".join(f"{v:.12e}" for v in P.ravel())
                    + "\n")
        f.write("Tr: " + " ".join(["0"] * 12) + "\n")
    (tmp_path / "poses").mkdir()
    poses = np.tile(np.eye(4)[:3].ravel(), (3, 1))
    poses[:, 11] = [0.0, 0.8, 1.6]
    np.savetxt(tmp_path / "poses" / "00.txt", poses)
    monkeypatch.setenv("KITTI_ROOT", str(tmp_path))
    return tmp_path


def test_kitti_absent_without_a_root(monkeypatch):
    monkeypatch.delenv("KITTI_ROOT", raising=False)
    assert kitti.available() is False and jkitti.available() is False


def test_kitti_loader_equals_jax(kitti_tree):
    assert kitti.available() and jkitti.available()
    got, want = kitti.load_calib(), jkitti.load_calib()
    np.testing.assert_array_equal(got["K"], want["K"])
    assert got["baseline"] == want["baseline"] and got["baseline"] > 0.5
    np.testing.assert_array_equal(kitti.load_poses(), jkitti.load_poses())
    assert kitti.frame_paths() == jkitti.frame_paths()
    for p in kitti.frame_paths()[0]:
        np.testing.assert_array_equal(kitti.load_frame(p),
                                      jkitti.load_frame(p))
    pairs, jpairs = list(kitti.frame_stream()), list(jkitti.frame_stream())
    assert len(pairs) == len(jpairs) == 3
    for (a, b), (c, d) in zip(pairs, jpairs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert (dataclasses.asdict(kitti.KITTI_SGBM)
            == dataclasses.asdict(jkitti.KITTI_SGBM))
