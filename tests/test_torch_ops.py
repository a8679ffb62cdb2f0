"""The PyTorch port's small ops against the JAX package on the same inputs:
remap, reprojection, Hamming matching, the inf-aware sampler, Kabsch and
SE(3); plus the port's import and precision contracts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openvo_tpu.geometry import reproject as jreproject
from openvo_tpu.geometry import se3 as jse3
from openvo_tpu.ops import hamming as jhamming
from openvo_tpu.ops import interpolate as jinterp
from openvo_tpu.ops import remap as jremap
from openvo_tpu.pose import kabsch as jkabsch
from openvo_tpu_torch.geometry import reproject, se3
from openvo_tpu_torch.ops import hamming, interpolate, remap
from openvo_tpu_torch.pose import kabsch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(a):
    return torch.from_numpy(np.array(a))


def test_remap_matches_jax_gather_form():
    """The gather form as JAX runs it eagerly, op by op (the camera's
    eager rectification); the camera's compiled form is ``make_remap``'s."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 256, (40, 56)).astype(np.float32)
    yy, xx = np.mgrid[0:40, 0:56].astype(np.float32)
    # fractional, partly out-of-bounds coordinates
    mx = (xx * 1.07 - 2.3 + rng.uniform(-0.5, 0.5, xx.shape)).astype(np.float32)
    my = (yy * 1.03 - 1.7 + rng.uniform(-0.5, 0.5, yy.shape)).astype(np.float32)
    ref = np.asarray(jremap.remap_bilinear(jnp.asarray(src), jnp.asarray(mx),
                                           jnp.asarray(my)))
    out = remap.remap_bilinear(t(src), t(mx), t(my)).numpy()
    np.testing.assert_array_equal(out, ref)
    # and the bounded roll+select form the JAX camera picks agrees
    bounded = np.asarray(jremap.make_remap(mx, my)(jnp.asarray(src)))
    np.testing.assert_allclose(out, bounded, rtol=0, atol=1e-4)


def test_reprojection_keeps_ieee_inf():
    rng = np.random.default_rng(1)
    disp = rng.uniform(1, 60, (24, 32)).astype(np.float32)
    disp[3, 4] = 0.0        # W == 0 -> inf
    disp[5, 6] = -1.0
    Q = np.array([[1, 0, 0, -15.5], [0, 1, 0, -11.5], [0, 0, 0, 280.0],
                  [0, 0, 2.0, -0.0]], np.float32)
    ref = np.asarray(jreproject.reproject_image_to_3d(jnp.asarray(disp), Q))
    out = reproject.reproject_image_to_3d(t(disp), Q).numpy()
    assert np.isinf(out[3, 4]).all()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_ratio_test_match_matches_jax():
    rng = np.random.default_rng(2)
    d1 = rng.integers(0, 256, (96, 32), dtype=np.uint8)
    d2 = d1[rng.permutation(96)].copy()
    d2[:40] = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    d2[50:60] = d2[40:50]                 # duplicate rows: argmin ties
    m1 = rng.random(96) > 0.1
    m2 = rng.random(96) > 0.1
    ij, okj = jhamming.ratio_test_match(jnp.asarray(d1), jnp.asarray(d2),
                                        0.8, jnp.asarray(m1), jnp.asarray(m2))
    it, okt = hamming.ratio_test_match(t(d1), t(d2), 0.8, t(m1), t(m2))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    dj = jhamming.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_array_equal(
        hamming.hamming_distance_matrix(t(d1), t(d2)).numpy(), np.asarray(dj))


def test_pack_unpack_bits_match_jax():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (16, 256)).astype(np.uint8)
    packed = hamming.pack_bits(t(bits))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jhamming.pack_bits(bits)))
    np.testing.assert_array_equal(hamming.unpack_bits(packed).numpy(), bits)


def test_bilinear_sample_3d_inf_and_nan_cases():
    rng = np.random.default_rng(4)
    img = rng.uniform(-5, 5, (12, 16, 3)).astype(np.float32)
    img[4, 5, 2] = np.inf         # one bad neighbour: renormalized
    img[8:10, 8:10, 0] = -np.inf  # all four bad: 0/0 = NaN
    img[2, 2, 1] = np.nan         # NaN passes through into the sum
    xs = np.array([5.3, 8.5, 2.2, 15.0, 0.0, 4.9], np.float32)
    ys = np.array([4.6, 8.5, 2.7, 11.0, 0.0, 4.1], np.float32)
    ref = np.asarray(jinterp.bilinear_sample_3d(jnp.asarray(img),
                                                jnp.asarray(xs),
                                                jnp.asarray(ys)))
    out = interpolate.bilinear_sample_3d(t(img), t(xs), t(ys)).numpy()
    assert np.isnan(out[1]).all() and np.isfinite(out[0]).all()
    assert np.isnan(out[2]).any()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


def rigid_pair(n=64, seed=5, ang=0.3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    b = a @ R.T + np.float32([0.4, -0.2, 0.1])
    b += rng.normal(0, 0.01, b.shape).astype(np.float32)
    return a, b


def test_kabsch_matches_jax():
    a, b = rigid_pair()
    mask = np.ones(len(a), bool)
    mask[::7] = False
    a[::7] = np.inf               # invalid rows may hold anything
    ref = np.asarray(jkabsch.kabsch(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(mask)))
    out = kabsch.kabsch(t(a), t(b), t(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_kabsch_nan_contract():
    a, b = rigid_pair(8)
    mask = np.zeros(8, bool)
    mask[:2] = True               # fewer than 3 points
    assert np.isnan(kabsch.kabsch(t(a), t(b), t(mask)).numpy()).all()
    mask[:] = True
    a[3] = np.nan                 # NaN in a valid row poisons the fit
    assert np.isnan(kabsch.kabsch(t(a), t(b), t(mask)).numpy()).any()


def test_se3_matches_jax():
    a, b = rigid_pair()
    T = np.asarray(jkabsch.kabsch(jnp.asarray(a), jnp.asarray(b),
                                  jnp.ones(len(a), bool)))
    np.testing.assert_allclose(se3.inverse(t(T)).numpy(),
                               np.asarray(jse3.inverse(jnp.asarray(T))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.compose(t(T), t(T)).numpy(), T @ T,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(se3.rotation_magnitude(t(T[:3, :3]))),
        float(jse3.rotation_magnitude(jnp.asarray(T[:3, :3]))), atol=1e-6)


@pytest.mark.parametrize("home", ["openvo_tpu_torch.ops.image",
                                  "openvo_tpu_torch.models.stereo_camera"])
def test_bgr_to_gray_matches_jax(home):
    """bgr_to_gray lives in ops/image.py as in the JAX package; the camera
    module re-exports it."""
    import importlib

    from openvo_tpu.ops.image import bgr_to_gray as jax_gray

    bgr_to_gray = importlib.import_module(home).bgr_to_gray
    rng = np.random.default_rng(6)
    bgr = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    np.testing.assert_array_equal(bgr_to_gray(t(bgr)).numpy(),
                                  np.asarray(jax_gray(jnp.asarray(bgr))))


def test_cuda_path_import_turns_tf32_off():
    from openvo_tpu_torch.ops import orb_cuda, sgbm_cuda  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_never_imports_jax():
    code = ("import sys, openvo_tpu_torch\n"
            "import openvo_tpu_torch.models.stereo_odometer\n"
            "import openvo_tpu_torch.parallel.tiling\n"
            "import openvo_tpu_torch.ops.sgbm_cuda, openvo_tpu_torch.ops.orb_cuda\n"
            "import openvo_tpu_torch.ops.remap, openvo_tpu_torch.ops.image\n"
            "import openvo_tpu_torch.models.mono_odometer\n"
            "import openvo_tpu_torch.parallel.rig, openvo_tpu_torch.parallel.stream\n"
            "import openvo_tpu_torch.tools.bench, openvo_tpu_torch.entry\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'openvo_tpu' or m.startswith('openvo_tpu.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("fn", ["cost_hsweep", "brief_describe",
                                "resize_levels"])
def test_kernel_wrappers_have_launch_counters(fn):
    from openvo_tpu_torch.ops import orb_cuda, sgbm_cuda

    mod = sgbm_cuda if hasattr(sgbm_cuda, fn) else orb_cuda
    assert isinstance(getattr(mod, fn).launches, int)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
