"""Batched two-view augmentation on the device (counterpart of
byol_tpu/data/device_augment.py), the unfused in-step path.

Every stochastic DRAW is kept apart from its APPLY, as in the JAX package:

- draws (:func:`crop_window`, :func:`jitter_params`, :func:`blur_sigma`,
  :func:`view_params`) take a CPU ``torch.Generator`` and a batch size and
  return (B,) fp32 tensors.  They cannot give ``jax.random``'s numbers;
  they give the same distributions (tests/test_torch_augment.py holds
  them to JAX's with two-sample KS tests).  Gates are 0/1 fp32, compared
  ``> 0.5``, as the fused kernel's parameter vector carries them;
- applies (:func:`apply_crop`, :func:`apply_grayscale`,
  :func:`apply_color_jitter`, :func:`apply_gaussian_blur`,
  :func:`apply_view`, :func:`two_view`) are pure arithmetic on pre-drawn
  parameters, batched over the leading dimension, NHWC in and out.

The crop is not ``F.interpolate(antialias=True)``, which differs from
jax's ``scale_and_translate``: it contracts the image against the explicit
antialiased triangle weights of ``ops/fused_augment.py::_weight_mat`` at
fp32, so samples outside the input are zeroed as jax zeroes them.  The
fused kernel K2 (ops/fused_augment.py) consumes the same draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from byol_tpu_torch.core import rng as rng_lib


def _uniform(gen: torch.Generator, b: int, lo=0.0, hi=1.0) -> torch.Tensor:
    """(b,) fp32 draws from U(lo, hi); ``hi`` may be a (b,) tensor."""
    return lo + torch.rand(b, generator=gen, dtype=torch.float32) * (hi - lo)


def crop_window(gen: torch.Generator, b: int, h: int, w: int,
                scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """Draw ``b`` RandomResizedCrop windows ``(y0, x0, ch, cw)`` in source
    pixels: area U(scale)·A, log-uniform aspect in ``ratio``, both extents
    clamped to the image, offsets uniform in the remaining slack."""
    area = _uniform(gen, b, scale[0], scale[1]) * (h * w)
    r = torch.exp(_uniform(gen, b, math.log(ratio[0]), math.log(ratio[1])))
    cw = torch.sqrt(area * r).clamp(max=float(w))
    ch = torch.sqrt(area / r).clamp(max=float(h))
    y0 = _uniform(gen, b, 0.0, h - ch)
    x0 = _uniform(gen, b, 0.0, w - cw)
    return y0, x0, ch, cw


def jitter_params(gen: torch.Generator, b: int, strength: float):
    """Draw the color-jitter factors (brightness, contrast, saturation in
    U(max(0, 1 - 0.8s), 1 + 0.8s)) and the hue angle U(-0.2s, 0.2s)·2π."""
    bcs = 0.8 * strength
    hs = 0.2 * strength
    fb, fc, fs = (_uniform(gen, b, max(0.0, 1 - bcs), 1 + bcs)
                  for _ in range(3))
    theta = _uniform(gen, b, -hs, hs) * 2.0 * math.pi
    return fb, fc, fs, theta


def blur_sigma(gen: torch.Generator, b: int, sigma_range=(0.1, 2.0)):
    return _uniform(gen, b, *sigma_range)


class ViewParams(NamedTuple):
    """Every stochastic parameter of one view for a batch, in the JAX
    ``ViewParams`` order: (B,) fp32 tensors, gates as 0/1."""

    y0: torch.Tensor          # crop window (crop_window)
    x0: torch.Tensor
    ch: torch.Tensor
    cw: torch.Tensor
    flip: torch.Tensor        # gates
    jitter: torch.Tensor
    fb: torch.Tensor          # jitter factors (jitter_params)
    fc: torch.Tensor
    fs: torch.Tensor
    theta: torch.Tensor
    gray: torch.Tensor
    blur: torch.Tensor
    sigma: torch.Tensor       # blur sigma (blur_sigma)


def view_params(gen: torch.Generator, b: int, h: int, w: int,
                strength: float = 1.0) -> ViewParams:
    """Draw every parameter of one view for ``b`` images.  Gates: flip
    0.5, jitter 0.8, grayscale 0.2, blur 0.5."""
    y0, x0, ch, cw = crop_window(gen, b, h, w)
    gate = lambda p: (_uniform(gen, b) < p).float()
    flip, jitter = gate(0.5), gate(0.8)
    fb, fc, fs, theta = jitter_params(gen, b, strength)
    gray, blur = gate(0.2), gate(0.5)
    return ViewParams(y0=y0, x0=x0, ch=ch, cw=cw, flip=flip, jitter=jitter,
                      fb=fb, fc=fc, fs=fs, theta=theta, gray=gray, blur=blur,
                      sigma=blur_sigma(gen, b))


def step_views(seed: int, step: int, b: int, h: int, w: int,
               strength: float = 1.0, microbatch: int = 0
               ) -> Tuple[ViewParams, ViewParams]:
    """Both views' draws of microbatch ``microbatch`` (``b`` images) of
    optimizer step ``step``, on the CPU: a function of (seed, step,
    microbatch) alone (``core/rng.py::augment_generator``)."""
    gen = rng_lib.augment_generator(seed, step, microbatch)
    return (view_params(gen, b, h, w, strength),
            view_params(gen, b, h, w, strength))


def to_device(views: Sequence[ViewParams], device) -> Tuple[ViewParams, ...]:
    """Move the views' parameters to ``device`` in one copy that does not
    block the host (from pinned memory when the target is a card)."""
    device = torch.device(device)
    packed = torch.stack([torch.stack(tuple(p)) for p in views])
    if device.type == "cuda":
        packed = packed.pin_memory()
    packed = packed.to(device, non_blocking=True)
    return tuple(ViewParams(*row) for row in packed)


def _b(t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1), to broadcast over NHWC images."""
    return t.reshape(-1, 1, 1, 1)


def apply_crop(images: torch.Tensor, y0, x0, ch, cw, size: int
               ) -> torch.Tensor:
    """(B, H, W, C) fp32 -> (B, size, size, C): each window resampled by
    the antialiased triangle weights, then clipped to [0, 1]."""
    # ops/fused_augment.py imports this module, so import it here
    from byol_tpu_torch.ops import fused_augment as fused_lib
    h, w = images.shape[1:3]
    sy, sx = fused_lib.rdiv(size, ch), fused_lib.rdiv(size, cw)
    wy = fused_lib._weight_mat(h, size, sy, -y0 * sy)
    wx = fused_lib._weight_mat(w, size, sx, -x0 * sx)
    crop = fused_lib.crop_contract(images, wy[:, None], wx[:, None])[:, 0]
    return crop.clamp(0.0, 1.0)


def apply_flip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the width of the images whose gate is on."""
    return torch.where(_b(flip) > 0.5, images.flip(2), images)


def _gray(image: torch.Tensor) -> torch.Tensor:
    return (0.2989 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2]).unsqueeze(-1)


def apply_grayscale(image: torch.Tensor) -> torch.Tensor:
    """Three-channel grayscale (the torchvision RandomGrayscale branch)."""
    return _gray(image).expand(image.shape).contiguous()


def apply_color_jitter(image: torch.Tensor, fb, fc, fs, theta, *,
                       hue: bool) -> torch.Tensor:
    """brightness / contrast / saturation (.8s) + hue (.2s), torch
    semantics: multiplicative brightness; contrast blends toward the mean
    gray of each whole image, saturation toward its gray; the hue is a
    rotation in YIQ space.  Every stage is clipped to [0, 1]."""
    image = (image * _b(fb)).clamp(0.0, 1.0)
    mean = _gray(image).mean(dim=(1, 2, 3), keepdim=True)
    fc, fs = _b(fc), _b(fs)
    image = (fc * image + (1 - fc) * mean).clamp(0.0, 1.0)
    image = (fs * image + (1 - fs) * _gray(image)).clamp(0.0, 1.0)
    if hue:
        r, g, b_ = image.unbind(-1)
        y = 0.299 * r + 0.587 * g + 0.114 * b_
        i = 0.596 * r - 0.274 * g - 0.322 * b_
        q = 0.211 * r - 0.523 * g + 0.312 * b_
        cos = torch.cos(theta).reshape(-1, 1, 1)
        sin = torch.sin(theta).reshape(-1, 1, 1)
        i, q = cos * i + sin * q, -sin * i + cos * q
        image = torch.stack([y + 0.956 * i + 0.621 * q,
                             y - 0.272 * i - 0.647 * q,
                             y - 1.106 * i + 1.703 * q], dim=-1)
        image = image.clamp(0.0, 1.0)
    return image


def apply_gaussian_blur(sigma: torch.Tensor, image: torch.Tensor,
                        kernel_size: int) -> torch.Tensor:
    """Separable gaussian blur, each image with its own sigma: the width
    pass, then the height pass, over reflect-101 borders.  One grouped
    depthwise conv over (1, B·C, H, W) gives every image its own kernel."""
    k = max(int(kernel_size) | 1, 3)
    x = torch.arange(-(k // 2), k // 2 + 1, dtype=image.dtype,
                     device=image.device)
    g = torch.exp(-(x ** 2) / (2.0 * sigma.reshape(-1, 1) ** 2))
    g = g / g.sum(dim=1, keepdim=True)
    n, hh, ww, ch = image.shape
    r = k // 2
    taps = g.repeat_interleave(ch, dim=0)                  # (B·C, k)
    img = image.permute(0, 3, 1, 2).reshape(1, n * ch, hh, ww)
    img = F.pad(img, (r, r, r, r), mode="reflect")
    img = F.conv2d(img, taps.reshape(n * ch, 1, 1, k), groups=n * ch)
    img = F.conv2d(img, taps.reshape(n * ch, 1, k, 1), groups=n * ch)
    return img.reshape(n, ch, hh, ww).permute(0, 2, 3, 1).contiguous()


def apply_view(p: ViewParams, images: torch.Tensor, size: int, *,
               strength: float = 1.0) -> torch.Tensor:
    """One view of every image from its pre-drawn parameters: (B, H, W, C)
    fp32 [0, 1] in, (B, size, size, C) fp32 out."""
    v = apply_crop(images, p.y0, p.x0, p.ch, p.cw, size)
    v = apply_flip(v, p.flip)
    v = torch.where(_b(p.jitter) > 0.5,
                    apply_color_jitter(v, p.fb, p.fc, p.fs, p.theta,
                                       hue=0.2 * strength > 0), v)
    v = torch.where(_b(p.gray) > 0.5, apply_grayscale(v), v)
    v = torch.where(_b(p.blur) > 0.5,
                    apply_gaussian_blur(p.sigma, v, int(0.1 * size)), v)
    return v.clamp(0.0, 1.0)


def two_view(images: torch.Tensor, size: int,
             views: Sequence[ViewParams], *, strength: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unfused batched two-view program: (B, H, W, C) uint8 or fp32
    [0, 1] -> two (B, size, size, C) fp32 views, contiguous NHWC."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    v1, v2 = (apply_view(p, images, size, strength=strength) for p in views)
    return v1, v2
