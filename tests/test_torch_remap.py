"""The port's remap helpers and Gaussian blur against the JAX package's, on
the CPU: ``remap_u8``, ``displacement_bounds``, ``make_remap`` against
JAX's bounded roll+select form on a distorting camera's maps, and
``gaussian_blur``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import openvo_tpu_torch
from openvo_tpu.ops import image as jimage
from openvo_tpu.ops import remap as jremap
from openvo_tpu_torch.ops import image, remap

from test_torch_camera import camera_args


def t(a):
    return torch.from_numpy(np.array(a))


def stray_maps(seed, h=40, w=56):
    """Fractional maps that scale, shift and jitter the grid, so that some
    samples fall outside the source on every side."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mx = (xx * 1.07 - 2.3 + rng.uniform(-0.5, 0.5, xx.shape)).astype(
        np.float32)
    my = (yy * 1.08 - 1.7 + rng.uniform(-0.5, 0.5, yy.shape)).astype(
        np.float32)
    return mx, my


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("channels", [None, 3])
def test_remap_u8_matches_jax(seed, channels):
    """uint8 out, rounded half to even and clipped, as JAX's; the maps
    reach past every edge of the source."""
    mx, my = stray_maps(seed)
    rng = np.random.default_rng(10 + seed)
    shape = (40, 56) if channels is None else (40, 56, channels)
    src = rng.integers(0, 256, shape).astype(np.uint8)
    assert (mx < 0).any() and (mx > 55).any() and (my < 0).any() \
        and (my > 39).any()
    ref = np.asarray(jremap.remap_u8(jnp.asarray(src), jnp.asarray(mx),
                                     jnp.asarray(my)))
    out = remap.remap_u8(t(src), t(mx), t(my)).numpy()
    assert out.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)
    # a source of 255s: the edge taps weigh in 0, the inside stays 255
    full = np.full(shape, 255, np.uint8)
    np.testing.assert_array_equal(
        remap.remap_u8(t(full), t(mx), t(my)).numpy(),
        np.asarray(jremap.remap_u8(jnp.asarray(full), jnp.asarray(mx),
                                   jnp.asarray(my))))


@pytest.mark.parametrize("seed", [0, 1])
def test_displacement_bounds_matches_jax(seed):
    """Also with a NaN and an inf entry, which count as no displacement."""
    mx, my = stray_maps(seed)
    mx[3, 4], my[5, 6] = np.nan, np.inf
    want = jremap.displacement_bounds(mx, my)
    assert remap.displacement_bounds(mx, my) == want
    assert remap.displacement_bounds(t(mx), t(my)) == want


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("fractional", [False, True])
def test_make_remap_equals_jax_bounded_form(side, fractional):
    """On a barrel-distorting camera's rectify maps the port's gather form
    equals JAX's roll+select form as the JAX camera runs it: jitted, the
    maps and their displacement bounds constants of the program (the
    bounded form's products are folded and fused there; run eagerly it
    rounds each product alone and differs in a third of the pixels)."""
    seq, args = camera_args()
    cam = openvo_tpu_torch.StereoCamera(*args, device="cpu")
    mx, my = cam.map_left if side == "left" else cam.map_right
    mxn, myn = mx.numpy(), my.numpy()
    bounds = jremap.displacement_bounds(mxn, myn)
    assert bounds == remap.displacement_bounds(mx, my)
    assert bounds[0] < 0 < bounds[1] and bounds[2] < 0 < bounds[3]
    src = np.clip(seq[side][0], 0, 255).astype(np.float32)
    if fractional:
        src = (src + np.random.default_rng(3).random(src.shape)).astype(
            np.float32)
    ref = np.asarray(jax.jit(lambda a: jremap.remap_bilinear_bounded(
        a, jnp.asarray(mxn), jnp.asarray(myn), bounds))(jnp.asarray(src)))
    out = remap.make_remap(mx, my)(t(src)).numpy()
    np.testing.assert_array_equal(out, ref)
    # and JAX's make_remap picks the bounded form for these maps
    picked = np.asarray(jax.jit(jremap.make_remap(jnp.asarray(mxn),
                                                  jnp.asarray(myn)))(
        jnp.asarray(src)))
    np.testing.assert_array_equal(out, picked)


@pytest.mark.parametrize("ksize,sigma", [(7, 2.0), (5, 0.0), (9, 1.3)])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_gaussian_blur_matches_jax(ksize, sigma, dtype):
    """Bit-equal to JAX's ``gaussian_blur`` as called, eagerly: products
    and sums rounded one by one, horizontal then vertical, REFLECT_101
    borders (sigma 0: OpenCV's sigma from ksize)."""
    rng = np.random.default_rng(ksize)
    img = rng.integers(0, 256, (37, 53))
    img = (img.astype(np.uint8) if dtype == "uint8"
           else (img + rng.random(img.shape)).astype(np.float32))
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize, sigma))
    out = image.gaussian_blur(t(img), ksize, sigma).numpy()
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    # a stack of frames blurs frame by frame
    stack = image.gaussian_blur(t(np.stack([img, img[::-1].copy()])), ksize,
                                sigma).numpy()
    np.testing.assert_array_equal(stack[0], ref)
