"""K2 (the fused uint8 -> two-view augmentation) held against the JAX
package.

On the CPU the wrapper runs K2's plain version.  The weight build is held
to JAX's ``_weight_mat`` / ``crop_weight_mats`` at 1e-7 (another
summation order in the column totals moves a weight by at most 2 ulps),
on both arms: upsampling crops and the antialiased downsampling arm (raw
40 -> 32 and 28 -> 24, with windows larger than the view forced in).  The
plain version is held to JAX's ``_view_pipeline`` per op with forced gates
at 1e-6, and the whole ``fused_two_view`` to JAX's (its Pallas kernel in
interpret mode, as the JAX package's own tests run it) and to JAX's
unfused ``two_view`` at 1e-5, on JAX's draws for ``augment_keys(seed,
step, 1)[0]``.  The kernel itself runs only on a card: the ``cuda`` test
holds it against the plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byol_tpu.data import device_augment as jax_aug
from byol_tpu.ops import fused_augment as jax_fused
from byol_tpu.training.steps import augment_keys
from byol_tpu_torch.data import device_augment as aug
from byol_tpu_torch.ops import fused_augment as fused_lib
from tests.test_torch_augment import jax_views, to_torch_params, uint8_images

ARMS = [(40, 32), (28, 24)]          # (raw, view size)
W_TOL = dict(rtol=1e-7, atol=1e-7)


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


def test_kernel_inputs_pack_prm_as_jax():
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    jwy, jwx, jprm, jblur, jsigma = jax_fused.view_kernel_inputs(
        keys, 28, 28, 24, 1.0)
    p = to_torch_params(jax.vmap(lambda k: jax_aug.view_params(
        k, 28, 28, 1.0))(keys))
    wy, wx, prm, blur, sigma = fused_lib.view_kernel_inputs(p, 28, 28, 24)
    np.testing.assert_allclose(prm.numpy(), np.asarray(jprm), rtol=0,
                               atol=0)
    np.testing.assert_allclose(wx.numpy(), np.asarray(jwx), **W_TOL)
    assert torch.equal(blur, torch.from_numpy(np.array(jblur, np.float32)))
    assert prm.shape == (8, 6)


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
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    wy2, wx2, prm2 = (torch.stack([t(a), t(a)], 1) for a in (jwy, jwx, prm))
    v1, v2 = fused_lib.two_view_reference(torch.from_numpy(imgs), wy2, wx2,
                                          prm2, hue=hue)
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
    wy, wx = torch.zeros(2, 2, 28, 24), torch.zeros(2, 2, 28, 24)
    prm = torch.zeros(2, 2, 6)
    with pytest.raises(ValueError, match="uint8 or float32"):
        fused_lib.two_view(imgs.double(), wy, wx, prm, hue=True)
    with pytest.raises(ValueError, match="wx"):
        fused_lib.two_view(imgs, wy, wx[:, :, :20], prm, hue=True)
    with pytest.raises(ValueError, match="prm"):
        fused_lib.two_view(imgs, wy, wx, prm[..., :5], hue=True)
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        fused_lib.two_view(imgs[..., :2], wy, wx, prm, hue=True)
    meta = [t.to("meta") for t in (imgs, wy, wx, prm)]
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_lib.two_view(*meta, hue=True)


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
    per_view = [fused_lib.view_kernel_inputs(p, raw, raw, 224)
                for p in views]
    wy, wx, prm = (torch.stack([per_view[0][i], per_view[1][i]], dim=1)
                   for i in range(3))
    got = fused_lib.two_view(imgs, wy, wx, prm, hue=True)
    again = fused_lib.two_view(imgs, wy, wx, prm, hue=True)
    want = fused_lib.two_view_reference(imgs, wy, wx, prm, hue=True)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        assert torch.equal(g, a)
