"""K2 (the fused uint8 -> two-view augmentation) held against the JAX
package.

On the CPU the wrapper runs K2's plain version.  The weight build is held
to JAX's ``_weight_mat`` / ``crop_weight_mats`` at 1e-7 (another
summation order in the column totals moves a weight by at most 2 ulps),
on both arms: upsampling crops and the antialiased downsampling arm (raw
40 -> 32 and 28 -> 24, with windows larger than the view forced in).  The
bands K2 builds in the kernel (``crop_bands``), scattered back to dense,
are held to the same matrices and to jax.image's ``compute_weight_mat``
at 2.5e-7 (the column total summed over the band's taps in order, against
a sum over every row: 2 ulps of a weight below 1).  The plain version is
held to JAX's ``_view_pipeline`` per op with forced gates at 1e-6, and the
whole ``fused_two_view`` to JAX's (its Pallas kernel in interpret mode, as
the JAX package's own tests run it) and to JAX's unfused ``two_view`` at
1e-5, on JAX's draws for ``augment_keys(seed, step, 1)[0]``.  The kernel
itself runs only on a card: the ``cuda`` test holds it against the plain
version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jax_scale

from byol_tpu.data import device_augment as jax_aug
from byol_tpu.ops import fused_augment as jax_fused
from byol_tpu.training.steps import augment_keys
from byol_tpu_torch.data import device_augment as aug
from byol_tpu_torch.ops import fused_augment as fused_lib
from tests.test_torch_augment import jax_views, to_torch_params, uint8_images

ARMS = [(40, 32), (28, 24)]          # (raw, view size)
W_TOL = dict(rtol=1e-7, atol=1e-7)
BAND_TOL = dict(rtol=0, atol=2.5e-7)


def _crop(p) -> torch.Tensor:
    """A port ``ViewParams``'s crop window as K2's (B, 5) operand."""
    return fused_lib.view_kernel_inputs(p)[0]


def _two_views(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], dim=1)


def _jax_params(raw, n=32, seed=0):
    """JAX draws of one view for n images, with two windows forced larger
    than the view (the downsampling arm) and the flip on for half."""
    p = jax.vmap(lambda k: jax_aug.view_params(k, raw, raw, 1.0))(
        jax.random.split(jax.random.PRNGKey(seed), n))
    ch = p.ch.at[0].set(raw - 1.0).at[1].set(raw - 0.5)
    cw = p.cw.at[0].set(raw - 2.0).at[1].set(raw * 1.0)
    y0 = p.y0.at[0].set(0.5).at[1].set(0.25)
    x0 = p.x0.at[0].set(1.0).at[1].set(0.0)
    flip = jnp.arange(n) % 2 == 0
    return p._replace(ch=ch, cw=cw, y0=y0, x0=x0, flip=flip)


@pytest.mark.parametrize("raw,size", ARMS)
def test_weight_mats_match_jax_on_both_arms(raw, size):
    p = _jax_params(raw)
    assert float(jnp.max(p.ch)) > size and float(jnp.min(p.ch)) < size
    tp = to_torch_params(p)
    sy = fused_lib.rdiv(size, tp.ch)
    got = fused_lib._weight_mat(raw, size, sy, -tp.y0 * sy)
    jsy = size / p.ch
    want = jax.vmap(lambda s, t: jax_fused._weight_mat(raw, size, s, t))(
        jsy, -p.y0 * jsy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **W_TOL)
    wy, wx = fused_lib.crop_weight_mats(tp, raw, raw, size)
    jwy, jwx = jax.vmap(lambda q: jax_fused.crop_weight_mats(
        q, raw, raw, size))(p)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jwy), **W_TOL)
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), **W_TOL)
    assert wy.shape == (32, raw, size) and wy.dtype == torch.float32
    # the flip is a column permutation of wx, exactly
    plain = fused_lib.crop_weight_mats(tp._replace(
        flip=torch.zeros(32)), raw, raw, size)[1]
    assert torch.equal(wx[0], plain[0].flip(1))
    assert torch.equal(wx[1], plain[1])


def _scatter(first: torch.Tensor, weights: torch.Tensor,
             in_size: int) -> torch.Tensor:
    """Bands (B, out), (B, out, T) -> the dense (B, in_size, out)."""
    b, out, taps = weights.shape
    rows = (first.unsqueeze(-1) + torch.arange(taps)).transpose(1, 2)
    dense = torch.zeros(b, in_size, out)
    return dense.scatter_add_(1, rows, weights.transpose(1, 2))


def _band_case(case):
    """(raw, size, JAX ViewParams) for one band case: draws at 224 -> 224
    (every crop upsamples), 256 -> 224 with two windows wider than the
    view (the antialiased arm), every flip on, and windows touching the
    top/left and the bottom/right borders."""
    raw = 256 if case == "down_256_224" else 224
    p = jax.vmap(lambda k: jax_aug.view_params(k, raw, raw, 1.0))(
        jax.random.split(jax.random.PRNGKey(7), 8))
    if case == "down_256_224":
        p = p._replace(ch=p.ch.at[0].set(250.0).at[1].set(256.0),
                       cw=p.cw.at[0].set(240.5).at[1].set(256.0),
                       y0=p.y0.at[0].set(3.0).at[1].set(0.0),
                       x0=p.x0.at[0].set(15.5).at[1].set(0.0))
    elif case == "flip":
        p = p._replace(flip=jnp.ones(8, bool))
    elif case == "top_left":
        p = p._replace(y0=jnp.zeros(8), x0=jnp.zeros(8))
    elif case == "bottom_right":
        p = p._replace(y0=raw - p.ch, x0=raw - p.cw)
    return raw, 224, p


@pytest.mark.parametrize("case", ["up_224", "down_256_224", "flip",
                                  "top_left", "bottom_right"])
def test_crop_bands_match_dense_weights(case):
    raw, size, p = _band_case(case)
    tp = to_torch_params(p)
    ry, rw, cf, cw = fused_lib.crop_window_bands(tp, raw, raw, size)
    taps = fused_lib.band_taps(raw, size)
    assert rw.shape == (8, size, taps) and taps == 5
    assert int(ry.min()) >= 0 and int(ry.max()) + taps <= raw
    # no tap beyond the window: every column's weights sum to 1 or 0
    sums = rw.sum(-1)
    assert bool(((sums - 1).abs() < 1e-6).logical_or(sums == 0).all())
    wy, wx = _scatter(ry, rw, raw), _scatter(cf, cw, raw)
    dy, dx = fused_lib.crop_weight_mats(tp, raw, raw, size)
    torch.testing.assert_close(wy, dy, **BAND_TOL)
    torch.testing.assert_close(wx, dx, **BAND_TOL)
    # jax.image's own weight matrices (scale_and_translate's path)
    sy, sx = size / p.ch, size / p.cw
    mat = jax.vmap(lambda s, t: jax_scale.compute_weight_mat(
        raw, size, s, t, jax_scale._fill_triangle_kernel, True))
    jwy, jwx = mat(sy, -p.y0 * sy), mat(sx, -p.x0 * sx)
    jwx = jnp.where(p.flip[:, None, None], jwx[:, :, ::-1], jwx)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jwy), **BAND_TOL)
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), **BAND_TOL)


def test_kernel_inputs_pack_prm_as_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    jwy, jwx, jprm, jblur, jsigma = jax_fused.view_kernel_inputs(
        keys, 28, 28, 24, 1.0)
    p = to_torch_params(jax.vmap(lambda k: jax_aug.view_params(
        k, 28, 28, 1.0))(keys))
    crop, prm, blur, sigma = fused_lib.view_kernel_inputs(p)
    np.testing.assert_allclose(prm.numpy(), np.asarray(jprm), rtol=0,
                               atol=0)
    wy, wx = fused_lib.crop_weight_mats(
        fused_lib.CropWindow(*crop.unbind(1)), 28, 28, 24)
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), **W_TOL)
    np.testing.assert_allclose(wy.numpy(), np.asarray(jwy), **W_TOL)
    assert torch.equal(blur, torch.from_numpy(np.array(jblur, np.float32)))
    assert prm.shape == (8, 6) and crop.shape == (8, 5)


@pytest.mark.parametrize("jitter,gray,hue", [
    (0.0, 0.0, True), (1.0, 0.0, True), (1.0, 0.0, False), (0.0, 1.0, True),
    (1.0, 1.0, True)])
def test_plain_version_matches_jax_view_pipeline(jitter, gray, hue):
    raw, size = 28, 24
    p = _jax_params(raw, n=4, seed=2)
    imgs = uint8_images(4, raw=raw, seed=2)
    prm = jnp.stack([jnp.full(4, jitter), p.fb, p.fc, p.fs, p.theta,
                     jnp.full(4, gray)], axis=1).astype(jnp.float32)
    jwy, jwx = jax.vmap(lambda q: jax_fused.crop_weight_mats(
        q, raw, raw, size))(p)
    x = jnp.asarray(imgs).astype(jnp.float32) / 255.0
    want = jax.vmap(lambda im, a, b, c: jax_fused._view_pipeline(
        im, a, b, c, hue=hue))(x, jwy, jwx, prm)
    crop = _crop(to_torch_params(p))
    prm2 = torch.from_numpy(np.array(prm, np.float32))
    v1, v2 = fused_lib.two_view_reference(
        torch.from_numpy(imgs), _two_views(crop, crop),
        _two_views(prm2, prm2), size=size, hue=hue)
    np.testing.assert_allclose(v1.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert torch.equal(v1, v2)


@pytest.mark.parametrize("raw,size,dtype,strength", [
    (40, 32, "uint8", 1.0), (28, 24, "uint8", 1.0), (40, 32, "float32", 1.0),
    (28, 24, "uint8", 0.0)])
def test_fused_two_view_matches_jax(raw, size, dtype, strength):
    imgs = uint8_images(6, raw=raw, seed=5)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255.0
    key = augment_keys(11, 4, 1)[0]
    views = jax_views(key, 6, raw, raw, strength)
    launches = fused_lib.LAUNCHES
    got = fused_lib.fused_two_view(torch.from_numpy(imgs), size, views,
                                   strength=strength)
    assert fused_lib.LAUNCHES == launches        # CPU: the plain version
    want = jax_fused.fused_two_view(key, jnp.asarray(imgs), size,
                                    strength=strength, interpret=True)
    unfused = aug.two_view(torch.from_numpy(imgs), size, views,
                           strength=strength)
    for g, w, u in zip(got, want, unfused):
        assert g.shape == (6, size, size, 3) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(g, u, rtol=0, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    imgs = torch.from_numpy(uint8_images(2, raw=28))
    crop, prm = torch.zeros(2, 2, 5), torch.zeros(2, 2, 6)
    with pytest.raises(ValueError, match="uint8 or float32"):
        fused_lib.two_view(imgs.double(), crop, prm, size=24, hue=True)
    with pytest.raises(ValueError, match="crop"):
        fused_lib.two_view(imgs, crop[..., :4], prm, size=24, hue=True)
    with pytest.raises(ValueError, match="prm"):
        fused_lib.two_view(imgs, crop, prm[..., :5], size=24, hue=True)
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        fused_lib.two_view(imgs[..., :2], crop, prm, size=24, hue=True)
    with pytest.raises(ValueError, match="view size"):
        fused_lib.two_view(imgs, crop, prm, size=0, hue=True)
    with pytest.raises(ValueError, match="taps"):
        fused_lib.two_view(imgs, crop, prm, size=3, hue=True)
    meta = [t.to("meta") for t in (imgs, crop, prm)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_lib.two_view(*meta, size=24, hue=True)


@pytest.mark.cuda
@pytest.mark.parametrize("raw,u8", [(224, True), (256, True), (224, False)])
def test_kernel_matches_plain_version_on_the_card(raw, u8):
    """K2 against its plain version, TF32 off; bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 has no CPU mode (its plain "
                    "version is tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    views = aug.to_device(aug.step_views(0, 0, 8, raw, raw), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    imgs = torch.randint(0, 256, (8, raw, raw, 3), generator=gen,
                         device="cuda", dtype=torch.uint8)
    if not u8:
        imgs = imgs.float() / 255.0
    per_view = [fused_lib.view_kernel_inputs(p) for p in views]
    crop, prm = (_two_views(per_view[0][i], per_view[1][i]) for i in range(2))
    got = fused_lib.two_view(imgs, crop, prm, size=224, hue=True)
    again = fused_lib.two_view(imgs, crop, prm, size=224, hue=True)
    want = fused_lib.two_view_reference(imgs, crop, prm, size=224, hue=True)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        assert torch.equal(g, a)
