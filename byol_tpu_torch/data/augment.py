"""Two-view augmentation on the host (counterpart of byol_tpu/data/augment.py,
the JAX package's tf.data path), in torch on CPU tensors.  This is the
port's ``data_backend='tf'``: the value keeps its name so that one set of
flags names one run in both packages, but no TensorFlow runs here.

The recipe is the JAX module's: RandomResizedCrop (area 0.08-1, aspect
3/4-4/3, bilinear), flip p=.5, color jitter p=.8 in the fixed order
brightness, contrast, saturation, hue, grayscale p=.2, Gaussian blur
(kernel ``max(int(.1 * size) | 1, 3)``, sigma U(.1, 2), reflect-101
borders), and under ``spec='paper'`` the asymmetric view parameters of
:data:`_VIEW_PARAMS` (view 2 solarizes with p=.2 and blurs with p=.1).

Every stochastic DRAW is kept apart from its APPLY, as in
``data/device_augment.py``:

- draws (:func:`draw_view`) read a fixed budget of uniforms from a
  per-sample generator, :func:`view_generator`, seeded from (seed, epoch,
  dataset index, view).  A batch therefore does not depend on how many
  DataLoader workers made it, and a resumed epoch redraws what the
  interrupted one drew.  The numbers cannot be TF's Philox draws; their
  distributions are (tests/test_torch_host_augment.py holds them to TF's
  with two-sample KS tests);
- applies (:func:`crop_resize`, :func:`apply_post_crop`, :func:`adjust_hue`,
  :func:`test_resize`) are arithmetic on pre-drawn parameters, each the
  TF op's: ``tf.image.resize`` is a bilinear resize with half-pixel
  centres and no antialias (``F.interpolate(align_corners=False)``), the
  hue is ``tf.image.adjust_hue``'s HSV rotation (not the YIQ rotation of
  the device path), grayscale uses TF's weights.

The crop sampler is TF's ``sample_distorted_bounding_box``
(:func:`sample_crop`), not torchvision's: an aspect ratio uniform in the
range, then an integer height drawn uniformly between the heights whose
areas bound the area range, the width rounded from it, 10 attempts, then
the whole image.  The JAX module asks TF for it with an all-zero object
box; TF skips a box without pixels, so no attempt passes its overlap check
and every JAX crop is the whole image (ROADMAP.md, section 3).  The port
samples the crop the recipe names, as if the object box were the whole
image, which ``min_object_covered=0`` always covers.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from byol_tpu_torch.core import rng as rng_lib
from byol_tpu_torch.data import device_augment

# torchvision ColorJitter(.8s, .8s, .8s, .2s): the reference stack
REFERENCE_JITTER = (0.8, 0.8, 0.8, 0.2)

# Per-(spec, view) parameters: the reference spec is symmetric, the paper
# spec (BYOL, arXiv 2006.07733 App. B) asymmetric.
_VIEW_PARAMS = {
    ("reference", 0): dict(jitter=REFERENCE_JITTER, blur_p=0.5,
                           solarize_p=0.0),
    ("reference", 1): dict(jitter=REFERENCE_JITTER, blur_p=0.5,
                           solarize_p=0.0),
    ("paper", 0): dict(jitter=(0.4, 0.4, 0.2, 0.1), blur_p=1.0,
                       solarize_p=0.0),
    ("paper", 1): dict(jitter=(0.4, 0.4, 0.2, 0.1), blur_p=0.1,
                       solarize_p=0.2),
}

CROP_ATTEMPTS = 10
# uniforms per view: 4 per crop attempt (aspect, height, y, x), then flip,
# jitter gate, 4 jitter factors, grayscale gate, blur gate, sigma,
# solarize gate.  Every draw has its fixed place, so a branch not taken
# shifts no later draw.
_CROP_U = 4 * CROP_ATTEMPTS
N_UNIFORMS = _CROP_U + 10


def view_params(spec: str, view: int) -> dict:
    try:
        return _VIEW_PARAMS[(spec, view)]
    except KeyError:
        raise ValueError(f"unknown aug spec/view {(spec, view)!r}; specs: "
                         f"'reference' | 'paper', views: 0 | 1") from None


class HostViewParams(NamedTuple):
    """Every stochastic parameter of one view of one image."""

    y: int                    # crop box in source pixels (TF's integer box)
    x: int
    h: int
    w: int
    flip: bool
    jitter: bool
    fb: float                 # brightness, contrast, saturation factors
    fc: float
    fs: float
    hue: float                # adjust_hue delta, in turns
    gray: bool
    blur: bool
    sigma: float
    solarize: bool


def view_generator(seed: int, epoch: int, index: int,
                   view: int) -> torch.Generator:
    """The generator of one view's draws: a function of (seed, epoch,
    dataset index, view) alone."""
    return torch.Generator().manual_seed(rng_lib.stream_seed(
        seed, f"host_augment/{int(epoch)}/{int(index)}/{int(view)}"))


def _lrint(v) -> int:
    """C's lrintf: round half to even (Python's round does the same)."""
    return int(round(float(v)))


def _random_crop(u: Sequence[float], width: int, height: int,
                 min_area: np.float32, max_area: np.float32,
                 aspect: np.float32):
    """One attempt of TF's ``GenerateRandomCrop``
    (sample_distorted_bounding_box_op.cc) on the uniforms ``u[1:4]``:
    -> (y, x, h, w), or None when the attempt fails."""
    f32 = np.float32
    h = _lrint(np.sqrt(f32(min_area / aspect)))
    max_h = _lrint(np.sqrt(f32(max_area / aspect)))
    if _lrint(f32(max_h * aspect)) > width:
        max_h = int((width + 0.5 - 1e-7) / float(aspect))
        if _lrint(f32(max_h * aspect)) > width:
            max_h -= 1
    max_h = min(max_h, height)
    h = min(h, max_h)
    if h < max_h:          # uniform on the closed range [0, max_h - h]
        h += min(int(u[1] * (max_h - h + 1)), max_h - h)
    w = _lrint(f32(h * aspect))
    area = f32(w * h)
    if area < min_area:
        h += 1
        w = _lrint(f32(h * aspect))
        area = f32(w * h)
    if area < min_area:
        return None
    if area > max_area:
        h -= 1
        w = _lrint(f32(h * aspect))
        area = f32(w * h)
    if area < min_area or area > max_area:
        return None
    if w > width or h > height or w <= 0 or h <= 0:
        return None
    y = min(int(u[2] * (height - h)), height - h - 1) if h < height else 0
    x = min(int(u[3] * (width - w)), width - w - 1) if w < width else 0
    return y, x, h, w


def sample_crop(u: Sequence[float], h: int, w: int, scale=(0.08, 1.0),
                ratio=(3 / 4, 4 / 3)) -> Tuple[int, int, int, int]:
    """TF's ``sample_distorted_bounding_box`` with the whole image as the
    object box and ``min_object_covered=0``: up to 10 attempts, each an
    aspect ratio uniform in ``ratio`` and an integer box from
    :func:`_random_crop`, then the whole image.  -> (y, x, ch, cw)."""
    f32 = np.float32
    min_area = f32(f32(scale[0]) * f32(w) * f32(h))
    max_area = f32(f32(scale[1]) * f32(w) * f32(h))
    for a in range(CROP_ATTEMPTS):
        uu = u[4 * a:4 * a + 4]
        aspect = f32(f32(uu[0]) * f32(ratio[1] - ratio[0]) + f32(ratio[0]))
        box = _random_crop(uu, w, h, min_area, max_area, aspect)
        if box is not None:
            return box
    return 0, 0, h, w


def draw_view(gen: torch.Generator, h: int, w: int, strength: float = 1.0,
              *, jitter=REFERENCE_JITTER, blur_p: float = 0.5,
              solarize_p: float = 0.0) -> HostViewParams:
    """Every parameter of one view of an (h, w) image from ``gen``."""
    u = torch.rand(N_UNIFORMS, generator=gen, dtype=torch.float64).tolist()
    y, x, ch, cw = sample_crop(u[:_CROP_U], h, w)
    b, c, s, hue = (f * strength for f in jitter)
    v = u[_CROP_U:]
    between = lambda t, lo, hi: lo + t * (hi - lo)
    return HostViewParams(
        y=y, x=x, h=ch, w=cw, flip=v[0] < 0.5, jitter=v[1] < 0.8,
        fb=between(v[2], max(0.0, 1.0 - b), 1.0 + b),
        fc=between(v[3], max(0.0, 1.0 - c), 1.0 + c),
        fs=between(v[4], max(0.0, 1.0 - s), 1.0 + s),
        hue=between(v[5], -hue, hue), gray=v[6] < 0.2, blur=v[7] < blur_p,
        sigma=between(v[8], 0.1, 2.0), solarize=v[9] < solarize_p)


def to_float(image) -> torch.Tensor:
    """uint8 (or float) HWC -> float32 in [0, 1]
    (``tf.image.convert_image_dtype``: x * (1/255))."""
    image = torch.as_tensor(image)
    if image.dtype == torch.uint8:
        return image.float() * (1.0 / 255.0)
    return image.float()


def _resize(image: torch.Tensor, size: int) -> torch.Tensor:
    """(H, W, C) -> (size, size, C): ``tf.image.resize(method='bilinear')``,
    half-pixel centres, no antialias."""
    out = F.interpolate(image.permute(2, 0, 1)[None], size=(size, size),
                        mode="bilinear", align_corners=False)
    return out[0].permute(1, 2, 0)


def crop_resize(image: torch.Tensor, p: HostViewParams,
                size: int) -> torch.Tensor:
    """The crop box of ``p`` of a float (H, W, C) image, resized to
    (size, size, C)."""
    return _resize(image[p.y:p.y + p.h, p.x:p.x + p.w], size)


def test_resize(image, size: int) -> torch.Tensor:
    """The eval transform: resize only, no crop, no normalisation, then
    the [0, 1] clip (``augment.test_resize``)."""
    return _resize(to_float(image), size).clamp(0.0, 1.0)


def _col(values, dtype=torch.float32) -> torch.Tensor:
    """Per-row scalars -> (B, 1, 1, 1) to broadcast over NHWC."""
    return torch.tensor(values, dtype=dtype).reshape(-1, 1, 1, 1)


def _gray(image: torch.Tensor) -> torch.Tensor:
    """``tf.image.rgb_to_grayscale``: (..., 3) -> (..., 1)."""
    return (0.2989 * image[..., 0:1] + 0.587 * image[..., 1:2]
            + 0.114 * image[..., 2:3])


def adjust_hue(image: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``tf.image.adjust_hue`` on float RGB (..., 3): to HSV with hue in
    turns (TF's CPU kernel, adjust_hue_op.cc), hue + delta wrapped to
    [0, 1), back to RGB by the closed form of TF's six-sector table
    (channel n of (r, g, b) = v - c * clamp(min(k, 4 - k), 0, 1) with k =
    (n + 6 h) mod 6 for n = 5, 3, 1).  ``delta`` broadcasts against the
    image's leading dimensions (a (B, 1, 1) tensor for a batch)."""
    r, g, b = image.unbind(-1)
    v = torch.maximum(r, torch.maximum(g, b))
    c = v - torch.minimum(r, torch.minimum(g, b))        # chroma = s * v
    safe = torch.where(c > 0, c, 1.0)
    h = torch.where(r == v, (g - b) / safe,
                    torch.where(g == v, (b - r) / safe + 2.0,
                                (r - g) / safe + 4.0)) / 6.0
    h = torch.where(c > 0, h, 0.0)
    h = h + delta
    dh = (h - torch.floor(h)) * 6.0
    return torch.stack([v - c * _sector(n, dh) for n in (5.0, 3.0, 1.0)],
                       dim=-1)


def _sector(n: float, dh: torch.Tensor) -> torch.Tensor:
    k = torch.remainder(n + dh, 6.0)
    return torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)


def apply_post_crop(views: torch.Tensor, params: Sequence[HostViewParams],
                    *, hue: bool = True) -> torch.Tensor:
    """Everything after the crop on the rows of ``views`` (B, S, S, 3)
    float32, each row with its own parameters, each stage on the rows its
    gate selects: flip, color jitter (brightness, contrast, saturation,
    then the hue when ``hue``; each blend clipped), grayscale, blur,
    solarize, the final clip (``augment.post_crop_augment``)."""
    size = views.shape[1]
    v = views.clone()

    def rows(gate):
        return [i for i, p in enumerate(params) if getattr(p, gate)]

    def col(sel, name):
        return _col([getattr(params[i], name) for i in sel])

    sel = rows("flip")
    if sel:
        v[sel] = v[sel].flip(2)
    sel = rows("jitter")
    if sel:
        fc, fs = col(sel, "fc"), col(sel, "fs")
        j = (v[sel] * col(sel, "fb")).clamp_(0.0, 1.0)
        mean = _gray(j).mean(dim=(1, 2, 3), keepdim=True)
        j = (fc * j + (1.0 - fc) * mean).clamp_(0.0, 1.0)
        j = (fs * j + (1.0 - fs) * _gray(j)).clamp_(0.0, 1.0)
        if hue:
            j = adjust_hue(j, col(sel, "hue")[..., 0]).clamp_(0.0, 1.0)
        v[sel] = j
    sel = rows("gray")
    if sel:
        v[sel] = _gray(v[sel]).expand(len(sel), size, size, 3)
    sel = rows("blur")
    if sel:
        sigma = torch.tensor([params[i].sigma for i in sel],
                             dtype=torch.float32)
        v[sel] = device_augment.apply_gaussian_blur(sigma, v[sel],
                                                    int(0.1 * size))
    sel = rows("solarize")
    if sel:
        part = v[sel]
        v[sel] = torch.where(part < 0.5, part, 1.0 - part)
    return v.clamp_(0.0, 1.0)


def two_views(images: Sequence, indices: Sequence[int], size: int, *,
              seed: int, epoch: int, strength: float = 1.0,
              spec: str = "reference") -> Tuple[np.ndarray, np.ndarray]:
    """Two independently augmented views of each image: ``images`` a batch
    or a list of (H, W, 3) uint8 (or float [0, 1]) images, each of its own
    size, ``indices`` their dataset indices.  -> two (B, size, size, 3)
    float32 arrays in [0, 1]."""
    out: List[np.ndarray] = []
    floats = [to_float(im) for im in images]
    for view in (0, 1):
        vp = view_params(spec, view)
        params = [draw_view(view_generator(seed, epoch, i, view),
                            im.shape[0], im.shape[1], strength, **vp)
                  for im, i in zip(floats, indices)]
        cropped = torch.stack([crop_resize(im, p, size)
                               for im, p in zip(floats, params)])
        out.append(apply_post_crop(cropped, params,
                                   hue=vp["jitter"][3] * strength > 0
                                   ).numpy())
    return out[0], out[1]

