"""The port's host two-view augmentation (byol_tpu_torch/data/augment.py,
``data_backend='tf'``) against the JAX package's tf.data path
(byol_tpu/data/augment.py), run here in TensorFlow.

- Applies: the test makes TF's draws itself, with the JAX module's own
  ``_split`` and ``_uniform`` on its seed structure, and hands them to the
  port's applies; outputs agree with the TF ops' to 1e-5 (max abs).
- Draws: two-sample KS tests (p > 1e-3) against TF's stateless draws over
  1000 seeds, and binomial bounds on the gates.  The crop is held to TF's
  ``stateless_sample_distorted_bounding_box`` with the whole image as the
  object box.  The JAX module passes an all-zero box, which TF skips as
  empty, so its sampler always returns the whole image; the last test
  pins that observation (ROADMAP.md, section 3).
"""
import numpy as np
import pytest
import tensorflow as tf
import torch
from scipy import stats

from byol_tpu.data import augment as A
from byol_tpu_torch.data import augment as P

TOL = 1e-5
H, W = 48, 40
N_SEEDS = 1000


def _image(h=H, w=W, seed=0):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _close(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= TOL, (what, err)


def _params(**kw):
    base = dict(y=0, x=0, h=H, w=W, flip=False, jitter=False, fb=1.0,
                fc=1.0, fs=1.0, hue=0.0, gray=False, blur=False, sigma=1.0,
                solarize=False)
    base.update(kw)
    return P.HostViewParams(**base)


def _post(image, **kw):
    return P.apply_post_crop(torch.from_numpy(image)[None],
                             [_params(**kw)])[0]


def _u(seed, lo=0.0, hi=1.0):
    return float(A._uniform(seed, (), lo, hi))


def _seed(i):
    return tf.constant([i, 7], tf.int32)


@pytest.mark.parametrize("size", [64, 24])     # upsampling, downsampling
def test_crop_on_tfs_box_then_resize(size):
    image = _image()
    for i in range(4):
        begin, extent, _ = tf.image.stateless_sample_distorted_bounding_box(
            (H, W, 3), bounding_boxes=tf.constant([[[0., 0., 1., 1.]]]),
            seed=_seed(i), min_object_covered=0.0,
            aspect_ratio_range=(3 / 4, 4 / 3), area_range=(0.08, 1.0),
            max_attempts=10, use_image_if_no_bounding_boxes=True)
        want = tf.image.resize(tf.slice(image, begin, extent), (size, size),
                               method="bilinear")
        (y, x, _), (h, w, _) = begin.numpy(), extent.numpy()
        got = P.crop_resize(torch.from_numpy(image),
                            _params(y=y, x=x, h=h, w=w), size)
        _close(got, want, (i, size))
    # the JAX module's own crop (its box is the whole image, see above)
    want = A.random_resized_crop(image, size, _seed(9))
    _close(P.crop_resize(torch.from_numpy(image), _params(), size), want)


def test_flip_on_tfs_gate():
    image = _image(16, 16)
    for i in range(6):
        want = tf.image.stateless_random_flip_left_right(image, _seed(i))
        _close(_post(image, h=16, w=16, flip=_u(_seed(i)) < 0.5), want, i)


@pytest.mark.parametrize("factors", [(0.8, 0, 0, 0), (0, 0.8, 0, 0),
                                     (0, 0, 0.8, 0), (0, 0, 0, 0.2),
                                     (0.8, 0.8, 0.8, 0.2)],
                         ids=["brightness", "contrast", "saturation", "hue",
                              "all"])
def test_color_jitter_stages(factors):
    image = _image(20, 20, seed=1)
    for i in range(4):
        seed = _seed(i)
        want = A.color_jitter(image, 1.0, seed, factors=factors)
        s = A._split(seed, 4)
        b, c, sat, h = factors
        got = _post(image, h=20, w=20, jitter=True,
                    fb=_u(s[0], max(0.0, 1 - b), 1 + b),
                    fc=_u(s[1], max(0.0, 1 - c), 1 + c),
                    fs=_u(s[2], max(0.0, 1 - sat), 1 + sat),
                    hue=_u(s[3], -h, h) if h else 0.0)
        _close(got, want, (factors, i))


@pytest.mark.parametrize("delta", [-0.5, -0.2, -0.03, 0.0, 0.11, 0.37, 0.5])
def test_adjust_hue_matches_tf(delta):
    image = _image(24, 24, seed=2)
    image[0, :4] = [[0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    want = tf.image.adjust_hue(image, delta)
    _close(P.adjust_hue(torch.from_numpy(image), torch.tensor(delta)), want)


def test_grayscale_and_solarize():
    image = _image(12, 12, seed=3)
    _close(_post(image, h=12, w=12, gray=True),
           A.random_grayscale(image, _seed(0), p=1.0))
    _close(_post(image, h=12, w=12, solarize=True),
           np.clip(A.solarize(image), 0.0, 1.0))


@pytest.mark.parametrize("size", [32, 64])
def test_blur_at_a_drawn_sigma_with_reflect101_borders(size):
    image = _image(size, size, seed=4)
    for i in range(3):
        want = A.gaussian_blur(image, int(0.1 * size), _seed(i))
        sigma = _u(_seed(i), 0.1, 2.0)
        _close(_post(image, h=size, w=size, blur=True, sigma=sigma),
               np.clip(want, 0.0, 1.0), (size, i))


def _tf_post_draws(seed, strength, spec, view):
    """TF's draws of ``post_crop_augment`` on ``seed``, as port params."""
    vp = A.view_params(spec, view)
    s = A._split(seed, 7)
    cs = A._split(s[2], 4)
    b, c, sat, h = (f * strength for f in vp["jitter"])
    return dict(flip=_u(s[0]) < 0.5, jitter=_u(s[1]) < 0.8,
                fb=_u(cs[0], max(0.0, 1 - b), 1 + b),
                fc=_u(cs[1], max(0.0, 1 - c), 1 + c),
                fs=_u(cs[2], max(0.0, 1 - sat), 1 + sat),
                hue=_u(cs[3], -h, h), gray=_u(s[3]) < 0.2,
                blur=_u(s[4]) < vp["blur_p"], sigma=_u(s[5], 0.1, 2.0),
                solarize=(vp["solarize_p"] > 0
                          and _u(s[6]) < vp["solarize_p"]))


@pytest.mark.parametrize("spec,view", [("reference", 0), ("paper", 0),
                                       ("paper", 1)])
def test_post_crop_chain_on_tfs_draws(spec, view):
    """The whole chain after the crop, the final clip included, batched
    over rows with their own draws."""
    size = 32
    images = np.stack([_image(size, size, seed=10 + i) for i in range(8)])
    wants, params = [], []
    for i in range(8):
        seed = _seed(100 + i)
        wants.append(A.post_crop_augment(
            images[i], size, seed, 1.0, **A.view_params(spec, view)))
        params.append(_params(h=size, w=size,
                              **_tf_post_draws(seed, 1.0, spec, view)))
    got = P.apply_post_crop(torch.from_numpy(images), params)
    _close(got, np.stack(wants), (spec, view))


@pytest.mark.parametrize("raw,size", [(32, 224), (64, 48)])
def test_test_resize(raw, size):
    image = (np.random.RandomState(raw).rand(raw, raw, 3) * 255).astype(
        np.uint8)
    want = A.test_resize(tf.image.convert_image_dtype(image, tf.float32),
                         size)
    got = P.test_resize(image, size)
    assert got.shape == (size, size, 3)
    _close(got, want)


# --------------------------------------------------------------------------
# draws, in distribution
# --------------------------------------------------------------------------

@tf.function
def _tf_crops(seeds):
    def one(seed):
        begin, extent, _ = tf.image.stateless_sample_distorted_bounding_box(
            (H, W, 3), bounding_boxes=tf.constant([[[0., 0., 1., 1.]]]),
            seed=seed, min_object_covered=0.0,
            aspect_ratio_range=(3 / 4, 4 / 3), area_range=(0.08, 1.0),
            max_attempts=10, use_image_if_no_bounding_boxes=True)
        return tf.concat([begin[:2], extent[:2]], 0)
    return tf.map_fn(one, seeds, fn_output_signature=tf.int32)


@tf.function
def _tf_draws(seeds, ranges, blur_p, solarize_p):
    """TF's draws of ``post_crop_augment`` per seed; ``ranges`` the
    (lo, hi) of the brightness, contrast, saturation and hue draws."""
    def one(seed):
        s = A._split(seed, 7)
        cs = A._split(s[2], 4)
        u = lambda k, lo=0.0, hi=1.0: A._uniform(k, (), lo, hi)
        gate = lambda k, p: tf.cast(u(k) < p, tf.float32)
        return tf.stack([
            gate(s[0], 0.5), gate(s[1], 0.8),
            *[u(cs[i], ranges[i][0], ranges[i][1]) for i in range(4)],
            gate(s[3], 0.2), gate(s[4], blur_p), u(s[5], 0.1, 2.0),
            gate(s[6], solarize_p)])
    return tf.map_fn(one, seeds, fn_output_signature=tf.float32)


FIELDS = ("flip", "jitter", "fb", "fc", "fs", "hue", "gray", "blur",
          "sigma", "solarize")


def _seeds():
    return tf.constant(np.stack([np.arange(N_SEEDS), np.full(N_SEEDS, 3)],
                                1), tf.int32)


def _port_draws(spec, view, h=H, w=W):
    vp = P.view_params(spec, view)
    return [P.draw_view(P.view_generator(11, 2, i, view), h, w, 1.0, **vp)
            for i in range(N_SEEDS)]


def test_crop_draws_match_tf_in_distribution():
    want = _tf_crops(_seeds()).numpy().astype(np.float64)
    got = np.array([d[:4] for d in _port_draws("reference", 0)], np.float64)
    for name, f in (("area", lambda a: a[:, 2] * a[:, 3] / (H * W)),
                    ("aspect", lambda a: a[:, 3] / a[:, 2]),
                    ("y", lambda a: a[:, 0]), ("x", lambda a: a[:, 1])):
        p = stats.ks_2samp(f(got), f(want)).pvalue
        assert p > 1e-3, (name, p)
    ys, xs, hs, ws = got.T
    assert (ys >= 0).all() and (ys + hs <= H).all()
    assert (xs >= 0).all() and (xs + ws <= W).all()
    assert ((hs * ws) >= 0.08 * H * W - 1).all()


@pytest.mark.parametrize("spec,view", [("reference", 0), ("paper", 0),
                                       ("paper", 1)])
def test_post_crop_draws_match_tf_in_distribution(spec, view):
    vp = A.view_params(spec, view)
    b, c, sat, h = vp["jitter"]
    ranges = [(max(0.0, 1 - f), 1 + f) for f in (b, c, sat)] + [(-h, h)]
    want = _tf_draws(_seeds(), ranges, vp["blur_p"],
                     vp["solarize_p"]).numpy()
    got = np.array([[float(getattr(d, f)) for f in FIELDS]
                    for d in _port_draws(spec, view)])
    rates = {"flip": 0.5, "jitter": 0.8, "gray": 0.2, "blur": vp["blur_p"],
             "solarize": vp["solarize_p"]}
    for j, name in enumerate(FIELDS):
        if name in rates:
            rate = rates[name]
            sd = np.sqrt(rate * (1 - rate) / N_SEEDS)
            for side in (got[:, j], want[:, j]):
                assert abs(side.mean() - rate) <= 4 * sd, (name, side.mean())
        else:
            p = stats.ks_2samp(got[:, j], want[:, j]).pvalue
            assert p > 1e-3, (name, p)


def test_two_views_differ_and_depend_only_on_their_streams():
    images = (np.random.RandomState(5).rand(6, 40, 36, 3) * 255).astype(
        np.uint8)
    idx = [3, 9, 4, 0, 17, 2]
    v1, v2 = P.two_views(images, idx, 32, seed=7, epoch=1)
    assert v1.shape == v2.shape == (6, 32, 32, 3)
    assert v1.dtype == np.float32 and 0 <= v1.min() and v1.max() <= 1
    assert all(not np.array_equal(a, b) for a, b in zip(v1, v2))
    # a sample's views do not depend on its batch-mates or its position
    w1, w2 = P.two_views(images[::-1], idx[::-1], 32, seed=7, epoch=1)
    assert np.array_equal(w1[::-1], v1) and np.array_equal(w2[::-1], v2)
    # another epoch draws again
    e1, _ = P.two_views(images, idx, 32, seed=7, epoch=2)
    assert not np.array_equal(e1, v1)
    p1, p2 = P.two_views(images, idx, 32, seed=7, epoch=1, spec="paper")
    assert not np.array_equal(p2, v2)


def test_jax_tf_crop_is_the_whole_image():
    """The JAX module's sampler call (an all-zero object box) never
    samples: TF skips a box without pixels in its overlap check."""
    for i in range(16):
        begin, extent, _ = tf.image.stateless_sample_distorted_bounding_box(
            (H, W, 3), bounding_boxes=tf.zeros((1, 1, 4)), seed=_seed(i),
            min_object_covered=0.0, aspect_ratio_range=(3 / 4, 4 / 3),
            area_range=(0.08, 1.0), max_attempts=10,
            use_image_if_no_bounding_boxes=True)
        assert list(begin.numpy()[:2]) == [0, 0]
        assert list(extent.numpy()[:2]) == [H, W]
