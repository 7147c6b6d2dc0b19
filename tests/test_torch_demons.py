"""The port's demons registration (``cbctmc_tpu_torch.registration.demons``)
against the JAX package's on the CPU, on the same seeded numpy inputs.

On the CPU every kernel wrapper runs its plain version. Tolerances, each
against the JAX function: the pull, the force and the Jacobian 2e-6 of
their scale (XLA on the CPU may fuse a product and a sum into one FMA, the
port rounds each; measured 0 here), the blur 1e-6 (XLA's convolution sums
the taps in its own order; measured 1.8e-7), the resize 4e-6 (the weights'
sums and the products' order; measured 1.8e-6), the percentile 1e-6 of the
range, five iterations of a level 2e-6 and a whole registration 2e-5 of the
field's largest value (measured 3.6e-7 and 2.9e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from cbctmc_tpu.registration import demons as jdemons

from cbctmc_tpu_torch.engine import kernels
from cbctmc_tpu_torch.registration import demons

torch.set_num_threads(2)

SHAPE = (24, 28, 20)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _smooth_field(rng, shape, amplitude):
    dvf = rng.normal(size=(3, *shape)).astype(np.float32)
    kernel = jnp.asarray(jdemons._gaussian_kernel1d(2.0))
    smooth = np.asarray(jdemons._blur3d(jnp.asarray(dvf), kernel))
    return (smooth * amplitude).astype(np.float32)


# dims below 2r + 1, ragged against the kernel's 16 y x 32 z tile, and longer
# than one x chunk of the coarsest level
BLUR_SHAPES = [SHAPE, (37, 29, 13), (8, 8, 8), (2, 5, 142), (88, 65, 36), (9, 300, 33)]


@pytest.mark.parametrize("shape", BLUR_SHAPES)
@pytest.mark.parametrize("sigma", [1.0, 1.25])
@pytest.mark.parametrize("channels", [1, 3])
def test_blur_matches_jax(shape, sigma, channels):
    rng = _rng(1)
    x = rng.random((channels, *shape) if channels == 3 else shape).astype(np.float32)
    k = demons._gaussian_kernel1d(sigma)
    np.testing.assert_array_equal(k, jdemons._gaussian_kernel1d(sigma))
    want = np.asarray(jdemons._blur3d(jnp.asarray(x), jnp.asarray(k)))
    got = demons.blur3d(_t(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the folded sum of the diffusion blur is the sum's blur, to the bit
    y = rng.random(x.shape).astype(np.float32)
    np.testing.assert_array_equal(demons.blur3d(_t(x), k, addend=_t(y)).numpy(),
                                  demons.blur3d(_t(x) + _t(y), k).numpy())


def test_trilinear_and_warp_match_jax():
    rng = _rng(2)
    vol = rng.random(SHAPE).astype(np.float32)
    dvf = (rng.normal(size=(3, *SHAPE)) * 4.0).astype(np.float32)  # samples off every face
    want = np.asarray(jdemons.warp_volume(jnp.asarray(vol), jnp.asarray(dvf)))
    got = demons.warp_volume(_t(vol), _t(dvf)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    coords = (np.indices(SHAPE, dtype=np.float32) + dvf).astype(np.float32)
    np.testing.assert_allclose(
        demons._trilinear_sample(_t(vol), _t(coords)).numpy(),
        np.asarray(jdemons._trilinear_sample(jnp.asarray(vol), jnp.asarray(coords))),
        rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", [SHAPE, (8, 8, 8), (2, 3, 5)])
def test_jacobian_matches_jax(shape):
    dvf = _smooth_field(_rng(3), shape, 3.0)
    want = np.asarray(jdemons.jacobian_determinant(jnp.asarray(dvf)))
    got = demons.jacobian_determinant(_t(dvf)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    ones = demons.jacobian_determinant(torch.zeros((3, *shape))).numpy()
    np.testing.assert_array_equal(ones, 1.0)
    # the select: the old field wherever the new one folds
    old = np.zeros_like(dvf)
    sel = demons.jacobian_select(_t(dvf), _t(old), 0.05).numpy()
    folded = want < np.float32(0.05)
    np.testing.assert_array_equal(sel, np.where(folded[None], old, dvf))


def test_force_matches_jax():
    rng = _rng(4)
    fixed = rng.random(SHAPE).astype(np.float32)
    moving = np.roll(fixed, 2, axis=0)
    mask = (rng.random(SHAPE) > 0.2).astype(np.float32)
    dvf = _smooth_field(rng, SHAPE, 2.0)
    tau = 2.0
    gx, gy, gz = jnp.gradient(jnp.asarray(fixed))
    warped = jdemons.warp_volume(jnp.asarray(moving), jnp.asarray(dvf))
    diff = (warped - jnp.asarray(fixed)) * jnp.asarray(mask)
    scale = -jnp.float32(tau) * diff / (gx * gx + gy * gy + gz * gz + diff * diff + 1e-9)
    want = np.asarray(jnp.stack([gx * scale, gy * scale, gz * scale]))
    grads = demons.level_gradients(_t(fixed))
    np.testing.assert_array_equal(grads[:3].numpy(),
                                  np.stack([np.asarray(g) for g in (gx, gy, gz)]))
    got = demons.demons_force(_t(moving), _t(fixed), _t(mask), _t(dvf), grads, tau).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("m, n", [(350, 175), (175, 88), (260, 130), (130, 65), (142, 71),
                                  (71, 36), (88, 175), (175, 350), (65, 130), (130, 260),
                                  (36, 71), (71, 142), (13, 7), (7, 13), (16, 8), (9, 8)])
def test_resize_matches_jax(m, n):
    """Each level shape of the full-width pyramid (350, 260, 142) <-> (175,
    130, 71) <-> (88, 65, 36), both directions, and odd sizes: one axis at a
    time (the resize is separable, one weight matrix per axis)."""
    x = _rng(5).random((m, 2, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (n, 2, 3), method="linear"))
    got = demons._resize3(_t(x), (n, 2, 3)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_resize3_matches_jax_on_volumes():
    rng = _rng(6)
    vol = rng.random((3, 13, 9, 10)).astype(np.float32)
    for shape in [(3, 7, 5, 5), (3, 26, 18, 20), (3, 13, 9, 10), (3, 8, 17, 4)]:
        want = np.asarray(jdemons._resize3(jnp.asarray(vol), shape))
        got = demons._resize3(_t(vol), shape).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


@pytest.mark.parametrize("size, ties", [(1000, False), (4097, True), (30 * 31 * 29, False)])
def test_percentile_matches_jax(size, ties):
    rng = _rng(7)
    x = rng.normal(size=size).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4
    want = np.asarray(jnp.percentile(jnp.asarray(x), jnp.array([1.0, 99.0])))
    got = demons._percentile(_t(x), [1.0, 99.0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * (x.max() - x.min()))


@pytest.mark.parametrize("masked, use_jacobian", [(False, True), (True, True), (True, False)])
def test_demons_level_matches_jax(masked, use_jacobian):
    rng = _rng(8)
    fixed = rng.random(SHAPE).astype(np.float32)
    moving = np.roll(fixed, 1, axis=0)
    mask = (np.ones(SHAPE) if not masked else rng.random(SHAPE)).astype(np.float32)
    dvf = _smooth_field(rng, SHAPE, 1.0)
    kf, kd = jdemons._gaussian_kernel1d(1.0), jdemons._gaussian_kernel1d(1.25)
    want = np.asarray(jdemons._demons_level(
        jnp.asarray(fixed), jnp.asarray(moving), jnp.asarray(dvf), 5, jnp.float32(2.0),
        jnp.asarray(kf), jnp.asarray(kd), jnp.asarray(mask), jnp.float32(0.05), use_jacobian))
    kernels.reset_launch_counts()
    got = demons._demons_level(_t(fixed), _t(moving), _t(dvf), 5, 2.0, kf, kd, _t(mask), 0.05,
                               use_jacobian).numpy()
    assert sum(kernels.launch_counts.values()) == 0  # CPU tensors: the plain versions
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
    plain = demons._demons_level(_t(fixed), _t(moving), _t(dvf), 5, 2.0, kf, kd, _t(mask), 0.05,
                                 use_jacobian, plain=True).numpy()
    np.testing.assert_array_equal(got, plain)


def _blob_case():
    shape = (32, 32, 32)
    coords = np.indices(shape).astype(np.float32)

    def blob(c):
        return np.exp(-(((coords[0] - c[0]) ** 2 + (coords[1] - c[1]) ** 2
                         + (coords[2] - c[2]) ** 2) / 30.0))

    return dict(moving=blob((19, 16, 16)), fixed=blob((16, 16, 16))), \
        dict(iterations=60, n_levels=2, tau=2.0), 0.35


def _masked_case():
    rng = np.random.default_rng(3)
    shape = (24, 24, 24)
    base = np.zeros(shape, np.float32)
    base[8:16, 8:16, 8:16] = 1.0
    base += rng.normal(scale=0.01, size=shape).astype(np.float32)
    moved = np.roll(base, 2, axis=0)
    mask = np.zeros(shape, np.float32)
    mask[4:20, 4:20, 4:20] = 1.0
    return dict(moving=base, fixed=moved, moving_mask=mask, fixed_mask=mask), \
        dict(iterations=60, n_levels=2), 0.5


@pytest.mark.parametrize("case", [_blob_case, _masked_case], ids=["blob", "masked"])
def test_register_matches_jax(case):
    """The JAX tests' two cases (tests/test_respiratory_4d.py): the port holds
    their assertions, and its field is within 2e-5 of its largest value of
    the JAX field."""
    inputs, params, ratio = case()
    want = jdemons.register(**inputs, parameters=jdemons.DemonsParameters(**params))
    got = demons.register(**inputs, parameters=demons.DemonsParameters(**params), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())

    moving, fixed = inputs["moving"], inputs["fixed"]
    warped = demons.warp_volume(_t(moving), _t(got)).numpy()
    assert np.abs(warped - fixed).mean() < ratio * np.abs(moving - fixed).mean()
    det = demons.jacobian_determinant(_t(got)).numpy()
    if "moving_mask" in inputs:
        assert det.min() > 0.0
    else:
        assert got[0, 14:19, 14:19, 14:19].mean() == pytest.approx(3.0, abs=1.2)
        assert abs(got[1, 14:19, 14:19, 14:19].mean()) < 1.0


def test_register_phases_matches_jax():
    rng = _rng(9)
    shape = (16, 12, 10)
    base = np.zeros(shape, np.float32)
    base[5:11, 4:8, 3:7] = 1.0
    images = np.stack([np.roll(base, s, axis=2) for s in (0, 1, 2)])
    images += rng.normal(scale=0.01, size=images.shape).astype(np.float32)
    params = dict(iterations=10, n_levels=2)
    want = jdemons.register_phases(images, reference_index=1,
                                   parameters=jdemons.DemonsParameters(**params))
    got = demons.register_phases(images, reference_index=1,
                                 parameters=demons.DemonsParameters(**params), device="cpu")
    assert got.shape == (3, 3, *shape)
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    vol = torch.zeros((6, 5, 4))
    dvf = torch.zeros((3, 6, 5, 4))
    with pytest.raises(TypeError):
        demons.warp_volume(vol.double(), dvf)
    with pytest.raises(ValueError):
        demons.warp_volume(vol, torch.zeros((3, 6, 5, 5)))
    with pytest.raises(ValueError):
        demons.warp_volume(torch.zeros((6, 1, 4)), torch.zeros((3, 6, 1, 4)))
    with pytest.raises(ValueError):
        demons.jacobian_select(dvf.transpose(1, 2), dvf, 0.05)
    taps = demons._gaussian_kernel1d(1.0)
    with pytest.raises(ValueError):
        demons.blur3d(vol, np.ones(4, np.float32) / 4)  # even taps
    with pytest.raises(ValueError):
        demons.blur3d(vol, np.ones(19, np.float32) / 19)  # radius 9
    with pytest.raises(ValueError):
        demons.blur3d(dvf[None], taps)  # 5-D
    with pytest.raises(ValueError):
        demons.blur3d(dvf, taps, addend=dvf[:2].contiguous())
    with pytest.raises(TypeError):
        demons.blur3d(vol, taps, addend=vol.double())
    with pytest.raises(ValueError):  # 2^31 values (shape only: no memory behind it)
        demons.blur3d(torch.empty((2**11, 2**10, 2**10), device="meta"), taps)
    grads = demons.level_gradients(vol)
    with pytest.raises(ValueError):
        demons.demons_force(vol, vol, vol, dvf, grads[:3].contiguous(), 2.0)
