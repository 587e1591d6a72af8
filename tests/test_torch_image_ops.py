"""The port's image utilities against the JAX package's, on the same numpy
inputs from a seed: ``ops/resize.py::imresize``, ``ops/niqe.py::
compute_niqe`` (the port's own copies: equal results), ``ops/image.py``
(``edge_map``, ``slice_image2patches`` / ``splice_patches2image``,
``gan_loss``: rewritten in torch), ``ops/metrics.py::ssim_gaussian`` and
``utils/visualization.py`` (``rgb2gray``, ``get_frequency_distribution``,
``make_image_grid``, a copy), with the cases of the JAX
``tests/test_misc_ops.py``.

Tolerances: the numpy copies must give equal arrays; the torch functions
compute in float32 like JAX and sum in another order where a reduction
runs (the edge map's channel mean, the losses' means, SSIM's 11 x 11
convolutions at full float32 precision on both sides): 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frequency_wised_all_in_one_image_restoration_model_tpu.ops import (
    image as jimage, metrics as jmetrics, niqe as jniqe, resize as jresize)
from frequency_wised_all_in_one_image_restoration_model_tpu.utils import (
    visualization as jvis)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.ops import (
    image as timage, metrics as tmetrics, niqe as tniqe, resize as tresize)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.utils import (
    visualization as tvis)

TOL = 1e-6
KERNELS = ("cubic", "box", "linear", "lanczos2", "lanczos3")


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("scale", [0.4, 1.0, 1.7])
def test_imresize_matches_jax(kernel, scale):
    img = _rng().uniform(0, 1, (16, 24, 3))
    got = tresize.imresize(img, scale=scale, kernel=kernel)
    np.testing.assert_array_equal(
        got, jresize.imresize(img, scale=scale, kernel=kernel))


def test_imresize_identity_and_constants():
    img = _rng().uniform(0, 1, (16, 16, 3))
    np.testing.assert_allclose(tresize.imresize(img, scale=1.0), img,
                               atol=1e-10)
    flat = np.full((16, 24, 3), 0.5)
    for kernel in KERNELS:
        for scale in (1.7, 0.4):
            np.testing.assert_allclose(
                tresize.imresize(flat, scale=scale, kernel=kernel), 0.5,
                atol=1e-9, err_msg=kernel)


def test_imresize_shapes_and_dtype():
    img = _rng().integers(0, 256, (20, 30, 3), dtype=np.uint8)
    up = tresize.imresize(img, scale=2.0)
    assert up.shape == (40, 60, 3) and up.dtype == np.uint8
    np.testing.assert_array_equal(up, jresize.imresize(img, scale=2.0))
    down = tresize.imresize(img, output_shape=(10, 15))
    assert down.shape == (10, 15, 3)
    np.testing.assert_array_equal(
        down, jresize.imresize(img, output_shape=(10, 15)))
    assert tresize.imresize(img[:, :, 0], scale=0.5).shape == (10, 15)


def test_imresize_antialiasing_widens_kernel():
    idx_aa, w_aa = tresize._contributions(64, 16, 0.25, tresize._cubic, 4.0,
                                          True)
    idx_no, w_no = tresize._contributions(64, 16, 0.25, tresize._cubic, 4.0,
                                          False)
    assert w_aa.shape[1] > 3 * w_no.shape[1]
    np.testing.assert_allclose(w_aa.sum(1), 1.0, atol=1e-12)
    np.testing.assert_allclose(w_no.sum(1), 1.0, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 8, 8, 3), (2, 12, 20, 3),
                                   (1, 9, 7, 1)])
def test_edge_map_matches_jax(shape):
    x = _rng(1).random(shape).astype(np.float32)
    got = timage.edge_map(torch.from_numpy(x))
    assert tuple(got.shape) == shape[:3] + (1,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jimage.edge_map(x)),
                               rtol=TOL, atol=TOL)


def test_edge_map_step_edge():
    x = torch.zeros(1, 8, 8, 3)
    x[:, :, 4:] = 1.0
    e = timage.edge_map(x)
    assert e[0, 0, 3, 0] > 0 and e[0, 0, 4, 0] > 0   # the edge's columns
    assert e[0, 0, 0, 0] == 0                       # flat


@pytest.mark.parametrize("patch,overlap", [(16, 0), (16, 2), (8, 3)])
def test_slice_splice_matches_jax(patch, overlap):
    img = _rng(2).uniform(0, 1, (32, 48, 3)).astype(np.float32)
    patches = timage.slice_image2patches(img, patch, overlap=overlap)
    np.testing.assert_array_equal(
        patches, jimage.slice_image2patches(img, patch, overlap=overlap))
    back = timage.splice_patches2image(patches, img.shape, overlap=overlap)
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(
        back, jimage.splice_patches2image(patches, img.shape, overlap=overlap))


def test_slice_rejects_a_partial_grid():
    with pytest.raises(ValueError):
        timage.slice_image2patches(np.zeros((30, 32, 3)), 16)


@pytest.mark.parametrize("mode", ["lsgan", "vanilla"])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    logits = (_rng(3).standard_normal((4, 6)) * 3).astype(np.float32)
    got = timage.gan_loss(torch.from_numpy(logits), real, mode)
    want = float(jimage.gan_loss(jnp.asarray(logits), real, mode))
    assert abs(got.item() - want) <= TOL * max(1.0, abs(want))


def test_gan_loss_unknown_mode():
    with pytest.raises(ValueError):
        timage.gan_loss(torch.zeros(2), True, "wgan")


@pytest.mark.parametrize("shape", [(2, 24, 24, 3), (1, 16, 40, 1)])
def test_ssim_gaussian_matches_jax(shape):
    rng = _rng(4)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    got = tmetrics.ssim_gaussian(torch.from_numpy(a), torch.from_numpy(b))
    want = float(jmetrics.ssim_gaussian(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(got.item() - want) <= TOL, (got.item(), want)
    same = tmetrics.ssim_gaussian(torch.from_numpy(a), torch.from_numpy(a))
    assert abs(same.item() - 1.0) <= TOL


def test_ssim_gaussian_is_differentiable():
    a = torch.rand(1, 16, 16, 3, requires_grad=True)
    tmetrics.ssim_gaussian(a, torch.rand(1, 16, 16, 3)).backward()
    assert torch.isfinite(a.grad).all() and a.grad.abs().sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_niqe_matches_jax(seed):
    rng = _rng(seed)
    img = rng.uniform(0, 1, (192, 192, 3))
    img[::2] *= 0.7     # some structure for the sharp-patch selection
    got = tniqe.compute_niqe(img)
    assert np.isfinite(got) and got == jniqe.compute_niqe(img)


def test_niqe_pristine_model_is_the_jax_one():
    mine, theirs = tniqe._default_model(), jniqe._default_model()
    np.testing.assert_array_equal(mine.mu, theirs.mu)
    np.testing.assert_array_equal(mine.cov, theirs.cov)


def test_visualization_matches_jax():
    rng = _rng(5)
    rgb = rng.uniform(0, 255, (20, 30, 3))
    np.testing.assert_array_equal(tvis.rgb2gray(rgb), jvis.rgb2gray(rgb))
    gray = jvis.rgb2gray(rgb)
    for size, norm in ((0.2, True), (0.1, False)):
        np.testing.assert_array_equal(
            tvis.get_frequency_distribution(gray, size, norm),
            jvis.get_frequency_distribution(gray, size, norm))
    images = [rng.random((8, 8, 3)) for _ in range(5)] + [rng.random((8, 8))]
    np.testing.assert_array_equal(tvis.make_image_grid(images, nrow=4),
                                  jvis.make_image_grid(images, nrow=4))
