"""The port's unfused in-step augmentation held against the JAX package.

``byol_tpu_torch/data/device_augment.py`` draws from a torch.Generator and
cannot give jax.random's numbers, so the apply functions and the whole
two-view program run here on JAX's draws (of ``augment_keys(seed, step,
1)[0]``, split as JAX's ``two_view`` splits it), injected as
``ViewParams``; images are made with numpy.  Tolerances: 1e-6 for one
op (fp32, another summation order in the crop contraction, the gray mean
and the blur conv), 1e-5 for the whole program (as the JAX package holds
its fused path to its unfused one).  The torch draws are held to JAX's in
distribution: a two-sample KS test per field over 4096 draws (p > 1e-3),
the gate frequencies within 4 sigma.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from byol_tpu.data import device_augment as jax_aug
from byol_tpu.training.steps import augment_keys
from byol_tpu_torch.core import config as torch_config
from byol_tpu_torch.data import device_augment as aug
from byol_tpu_torch.data.loader import get_loader

RAW, SIZE = 40, 32
FIELDS = aug.ViewParams._fields


def to_torch_params(p) -> aug.ViewParams:
    """A JAX ViewParams of (B,) arrays as the port's (gates 0/1 fp32)."""
    return aug.ViewParams(*(torch.from_numpy(np.array(x, np.float32))
                            for x in p))


def jax_views(key, b, h, w, strength=1.0):
    """JAX's draws of both views for ``key``, split as ``two_view`` and
    ``fused_two_view`` split it, as the port's ``ViewParams``."""
    k1, k2 = jax.random.split(key)
    return tuple(to_torch_params(jax.vmap(
        lambda k: jax_aug.view_params(k, h, w, strength))(
            jax.random.split(k, b))) for k in (k1, k2))


def jax_step_views(seed, strength=1.0):
    """A ``draw_views(step, b, h, w, microbatch)`` that hands the port
    JAX's draws of microbatch i, ``augment_keys(seed, step, k)[i]`` (key i
    does not depend on k)."""
    def draw(step, b, h, w, microbatch):
        key = augment_keys(seed, step, microbatch + 1)[microbatch]
        return jax_views(key, b, h, w, strength)
    return draw


def uint8_images(n=6, raw=RAW, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, raw, raw, 3)).astype(np.uint8)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def _case(seed=0, n=6):
    imgs = uint8_images(n, seed=seed).astype(np.float32) / 255.0
    key = augment_keys(seed, 3, 1)[0]
    return imgs, key, jax_views(key, n, RAW, RAW)[0]


def _per_image(fn, n):
    return np.stack([np.asarray(fn(i)) for i in range(n)])


def _f32(t, i):
    """Element i as a JAX fp32 scalar (a Python float would make JAX's
    window arithmetic float64)."""
    return jnp.float32(t[i].item())


def test_apply_crop_and_flip_match_jax():
    imgs, _, p = _case(0)
    got = aug.apply_crop(torch.from_numpy(imgs), p.y0, p.x0, p.ch, p.cw,
                         SIZE)
    want = _per_image(lambda i: jax_aug.apply_crop(
        imgs[i], _f32(p.y0, i), _f32(p.x0, i), _f32(p.ch, i),
        _f32(p.cw, i), SIZE), len(imgs))
    _close(got, want, 1e-6, "crop")
    flip = torch.tensor([1.0, 0.0] * 3)
    gate = flip.numpy()[:, None, None, None] > 0.5
    flipped = aug.apply_flip(got, flip)
    _close(flipped, np.where(gate, want[:, :, ::-1], want), 1e-6, "flip")
    _close(flipped, np.where(gate, got.numpy()[:, :, ::-1], got.numpy()),
           0.0, "flip is a permutation")


@pytest.mark.parametrize("hue", [True, False])
def test_apply_color_jitter_matches_jax(hue):
    imgs, _, p = _case(1)
    crops = np.random.RandomState(1).rand(6, SIZE, SIZE, 3).astype(
        np.float32)
    got = aug.apply_color_jitter(torch.from_numpy(crops), p.fb, p.fc, p.fs,
                                 p.theta, hue=hue)
    want = _per_image(lambda i: jax_aug.apply_color_jitter(
        crops[i], _f32(p.fb, i), _f32(p.fc, i), _f32(p.fs, i),
        _f32(p.theta, i), hue=hue), 6)
    _close(got, want, 1e-6)


def test_apply_grayscale_and_blur_match_jax():
    imgs, _, p = _case(2)
    crops = np.random.RandomState(2).rand(6, SIZE, SIZE, 3).astype(
        np.float32)
    _close(aug.apply_grayscale(torch.from_numpy(crops)),
           _per_image(lambda i: jax_aug.apply_grayscale(crops[i]), 6), 1e-6)
    for ksize in (int(0.1 * SIZE), 7):
        got = aug.apply_gaussian_blur(p.sigma, torch.from_numpy(crops),
                                      ksize)
        want = _per_image(lambda i: jax_aug.apply_gaussian_blur(
            _f32(p.sigma, i), crops[i], ksize), 6)
        _close(got, want, 1e-6, f"blur k={ksize}")
        assert got.is_contiguous()


@pytest.mark.parametrize("dtype,strength", [
    ("uint8", 1.0), ("float32", 1.0), ("uint8", 0.0), ("uint8", 0.5)])
def test_two_view_matches_jax(dtype, strength):
    imgs = uint8_images(6, seed=4)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255.0
    key = augment_keys(7, 2, 1)[0]
    want = jax_aug.two_view(key, jnp.asarray(imgs), SIZE, strength=strength)
    got = aug.two_view(torch.from_numpy(imgs), SIZE,
                       jax_views(key, 6, RAW, RAW, strength),
                       strength=strength)
    for g, w in zip(got, want):
        assert g.shape == (6, SIZE, SIZE, 3) and g.dtype == torch.float32
        assert g.is_contiguous()
        _close(g, w, 1e-5)


def test_draws_match_jax_in_distribution():
    n, h, w = 4096, 48, 40
    got = aug.view_params(torch.Generator().manual_seed(0), n, h, w, 1.0)
    want = jax.vmap(lambda k: jax_aug.view_params(k, h, w, 1.0))(
        jax.random.split(jax.random.PRNGKey(0), n))
    for name in FIELDS:
        g = getattr(got, name).numpy()
        x = np.asarray(getattr(want, name), np.float32)
        assert g.shape == (n,) and g.dtype == np.float32, name
        if name in ("flip", "jitter", "gray", "blur"):
            rate = {"flip": 0.5, "jitter": 0.8, "gray": 0.2, "blur": 0.5}[name]
            sd = np.sqrt(rate * (1 - rate) / n)
            assert set(np.unique(g)) <= {0.0, 1.0}, name
            assert abs(g.mean() - rate) < 4 * sd, (name, g.mean())
            assert abs(x.mean() - rate) < 4 * sd, (name, x.mean())
        else:
            p = stats.ks_2samp(g, x).pvalue
            assert p > 1e-3, (name, p)
    # the clamps: windows inside the image, sigma in its range
    assert (got.ch <= h).all() and (got.cw <= w).all()
    assert (got.y0 >= 0).all() and (got.y0 + got.ch <= h + 1e-4).all()
    assert (got.x0 >= 0).all() and (got.x0 + got.cw <= w + 1e-4).all()
    assert (got.sigma >= 0.1).all() and (got.sigma <= 2.0).all()


def test_step_draws_depend_only_on_seed_and_step():
    a = aug.step_views(5, 17, 8, RAW, RAW)
    b = aug.step_views(5, 17, 8, RAW, RAW)
    for pa, pb in zip(a, b):
        for x, y in zip(pa, pb):
            assert torch.equal(x, y)
    other = [aug.step_views(5, 18, 8, RAW, RAW), aug.step_views(6, 17, 8,
                                                                RAW, RAW)]
    for o in other:
        assert not torch.equal(o[0].y0, a[0].y0)
    assert not torch.equal(a[0].y0, a[1].y0)        # the two views differ
    moved = aug.to_device(a, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(moved[1], a[1]))


def _cfg(**task):
    cfg = torch_config.Config()
    return cfg.replace(task=dataclasses.replace(
        cfg.task, task="fake", batch_size=8, image_size_override=RAW, **task))


def test_step_placement_loader_ships_raw_uint8():
    bundle = get_loader(_cfg(augment_placement="step"), num_fake_samples=32)
    batches = list(bundle.train_loader)
    assert len(batches) == 4
    assert set(batches[0]) == {"images", "label"}
    assert batches[0]["images"].dtype == np.uint8
    assert batches[0]["images"].shape == (8, RAW, RAW, 3)
    assert batches[0]["label"].dtype == np.int32
    test = next(iter(bundle.test_loader))           # eval keeps the views
    assert test["view1"].dtype == np.float32


@pytest.mark.parametrize("change,match", [
    (dict(regularizer=dict(aug_spec="paper")), "'reference'"),
    (dict(task=dict(data_backend="device")), "mutually exclusive"),
    (dict(task=dict(augment_placement="host")), "unknown augment_placement")])
def test_loader_placement_checks(change, match):
    cfg = _cfg(augment_placement="step")
    for section, values in change.items():
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **values)})
    with pytest.raises(ValueError, match=match):
        get_loader(cfg, num_fake_samples=32)


AUG_DRIVE = ["--no-cuda", "--task", "fake", "--arch", "resnet18",
             "--image-size-override", "32", "--batch-size", "8", "--epochs",
             "2", "--debug-step", "--no-half", "--fused-update", "on",
             "--warmup", "0", "--head-latent-size", "32",
             "--projection-size", "16", "--augment-placement", "step",
             "--fused-augment", "on"]


def test_cli_trains_with_in_step_augmentation_on_the_cpu(capsys, tmp_path):
    from byol_tpu_torch.cli import main
    assert main(AUG_DRIVE + ["--model-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "augment_placement='step'" in out
    assert len([x for x in out.splitlines() if x.startswith("epoch ")]) == 2


def test_cli_refuses_fused_augment_with_loader_placement(capsys):
    from byol_tpu_torch.cli import main
    assert main(AUG_DRIVE[:-4] + ["--fused-augment", "on"]) == 2
    assert "requires --augment-placement step" in capsys.readouterr().err
