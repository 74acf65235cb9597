"""BYOL's two-view augmentation (appendix B of the paper) on drawn
parameters, in float32.

A view of a uint8 NHWC image, from its draws (the order of the fields of
``VIEW_FIELDS``):

1. random resized crop: the window (y0, x0, ch, cw) in source pixels,
   resampled to ``size`` x ``size`` by the antialiased triangle filter
   (``jax.image.scale_and_translate(method='bilinear')``: the filter
   widened by the downsampling factor, each output's weights normalised
   to sum 1, outputs whose sample point lies outside the image zero),
   then clipped to [0, 1];
2. horizontal flip where ``flip`` is set;
3. where ``jitter`` is set: brightness (multiply), contrast (blend toward
   the image's mean gray), saturation (blend toward the pixel's gray),
   each clipped, and a hue rotation by ``theta`` in YIQ space, clipped;
4. grayscale where ``gray`` is set (0.2989 R + 0.587 G + 0.114 B);
5. where ``blur`` is set, a separable gaussian of ``sigma`` over
   ``int(0.1 size) | 1`` taps with mirrored borders, width then height;
6. a final clip to [0, 1].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VIEW_FIELDS = ("y0", "x0", "ch", "cw", "flip", "jitter", "fb", "fc", "fs",
               "theta", "gray", "blur", "sigma")
_EPS = 1000.0 * torch.finfo(torch.float32).eps


def _resample_weights(in_size: int, out_size: int, start: torch.Tensor,
                      extent: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) weights of the window [start, start + extent)
    resampled to ``out_size`` samples."""
    scale = (out_size / extent).reshape(-1, 1, 1)
    inv = 1.0 / scale
    width = torch.clamp(inv, min=1.0)
    dev = start.device
    sample = ((torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5)
              * inv + start.reshape(-1, 1, 1) - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=dev).reshape(
        1, -1, 1)
    wts = torch.clamp(1.0 - (sample - src).abs() / width, min=0.0)
    total = wts.sum(dim=1, keepdim=True)
    wts = torch.where(total.abs() > _EPS, wts / total.clamp(min=_EPS), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, wts, 0.0)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return (0.2989 * x[..., 0] + 0.587 * x[..., 1]
            + 0.114 * x[..., 2]).unsqueeze(-1)


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, 1, 1, 1)


def _jitter(x, fb, fc, fs, theta, hue: bool):
    x = (x * _col(fb)).clamp(0.0, 1.0)
    mean = _gray(x).mean(dim=(1, 2, 3), keepdim=True)
    x = (_col(fc) * x + (1 - _col(fc)) * mean).clamp(0.0, 1.0)
    x = (_col(fs) * x + (1 - _col(fs)) * _gray(x)).clamp(0.0, 1.0)
    if not hue:
        return x
    r, g, b = x.unbind(-1)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    c, s = torch.cos(theta).reshape(-1, 1, 1), torch.sin(theta).reshape(
        -1, 1, 1)
    i, q = c * i + s * q, -s * i + c * q
    return torch.stack([y + 0.956 * i + 0.621 * q,
                        y - 0.272 * i - 0.647 * q,
                        y - 1.106 * i + 1.703 * q], dim=-1).clamp(0.0, 1.0)


def _blur(x: torch.Tensor, sigma: torch.Tensor, taps: int) -> torch.Tensor:
    k = max(taps | 1, 3)
    r = k // 2
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    g = torch.exp(-(t ** 2) / (2.0 * sigma.reshape(-1, 1) ** 2))
    g = g / g.sum(dim=1, keepdim=True)
    n, h, w, c = x.shape
    g = g.repeat_interleave(c, dim=0)
    y = F.pad(x.permute(0, 3, 1, 2).reshape(1, n * c, h, w), (r, r, r, r),
              mode="reflect")
    y = F.conv2d(y, g.reshape(n * c, 1, 1, k), groups=n * c)
    y = F.conv2d(y, g.reshape(n * c, 1, k, 1), groups=n * c)
    return y.reshape(n, c, h, w).permute(0, 2, 3, 1)


def view(images: torch.Tensor, p, size: int, strength: float = 1.0
         ) -> torch.Tensor:
    """One view of every image: uint8 (B, H, W, 3) and its draws ``p``
    (a sequence of (B,) tensors in ``VIEW_FIELDS`` order) -> (B, size,
    size, 3) float32."""
    d = dict(zip(VIEW_FIELDS, p))
    x = images.float() / 255.0
    _, h, w, _ = x.shape
    wy = _resample_weights(h, size, d["y0"], d["ch"])
    wx = _resample_weights(w, size, d["x0"], d["cw"])
    x = torch.einsum("nhwc,nha->nawc", x, wy)
    x = torch.einsum("nawc,nwb->nabc", x, wx).clamp(0.0, 1.0)
    on = lambda k: _col(d[k]) > 0.5
    x = torch.where(on("flip"), x.flip(2), x)
    x = torch.where(on("jitter"), _jitter(x, d["fb"], d["fc"], d["fs"],
                                          d["theta"], strength > 0), x)
    x = torch.where(on("gray"), _gray(x).expand(x.shape), x)
    x = torch.where(on("blur"), _blur(x, d["sigma"], int(0.1 * size)), x)
    return x.clamp(0.0, 1.0)


def draw_views(gen: torch.Generator, b: int, h: int, w: int,
               strength: float = 1.0):
    """Both views' draws for ``b`` images (BYOL's distributions: crop area
    U(0.08, 1) of the image, log-uniform aspect in [3/4, 4/3], each extent
    at most the image's; flip 0.5, jitter 0.8 with brightness, contrast
    and saturation U(1 - 0.8s, 1 + 0.8s) and hue U(-0.2s, 0.2s) turns,
    grayscale 0.2, blur 0.5 with sigma U(0.1, 2)) as two tuples of (B,)
    float32 CPU tensors, gates 0/1."""
    def u(lo=0.0, hi=1.0):
        return lo + torch.rand(b, generator=gen) * (hi - lo)

    def one():
        area = u(0.08, 1.0) * (h * w)
        ratio = torch.exp(u(math.log(3 / 4), math.log(4 / 3)))
        cw = torch.sqrt(area * ratio).clamp(max=float(w))
        ch = torch.sqrt(area / ratio).clamp(max=float(h))
        y0, x0 = u() * (h - ch), u() * (w - cw)
        gate = lambda prob: (u() < prob).float()
        flip, jitter = gate(0.5), gate(0.8)
        lo = max(0.0, 1 - 0.8 * strength)
        fb, fc, fs = u(lo, 1 + 0.8 * strength), u(lo, 1 + 0.8 * strength), \
            u(lo, 1 + 0.8 * strength)
        theta = u(-0.2 * strength, 0.2 * strength) * 2.0 * math.pi
        gray, blur = gate(0.2), gate(0.5)
        return (y0, x0, ch, cw, flip, jitter, fb, fc, fs, theta, gray, blur,
                u(0.1, 2.0))

    return one(), one()
