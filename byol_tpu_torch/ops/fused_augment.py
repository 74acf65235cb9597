"""Fused uint8 -> two-view augmentation: the Hopper kernel K2, its plain
version, the wrapper, and the crop weights in dense and band form.

Counterpart of byol_tpu/ops/fused_augment.py (the Pallas
``_two_view_kernel``).  The CUDA kernel is ``csrc/fused_augment.cu``; its
header states its bound at the ResNet-50 training shape and what the
design does about it.

- :func:`_weight_mat` / :func:`crop_weight_mats`: a crop window as the
  dense (in, size) antialiased triangle weights jax's
  ``scale_and_translate`` builds, batched over images, fp32 throughout;
  the horizontal flip is a column permutation of ``wx``.
- :func:`crop_bands` / :func:`crop_window_bands`: the same weights as
  bands, a window of :func:`band_taps` source indices per output index
  that holds every non-zero tap.  K2 builds them in the kernel with this
  arithmetic; no weight tensor reaches the card.
- :func:`view_kernel_inputs` packs one view's kernel operands: ``crop``
  in the ``_Y0, _X0, _CH, _CW, _FLIP`` layout and ``prm`` in the
  ``_JITTER, _FB, _FC, _FS, _THETA, _GRAY`` layout.
- :func:`two_view_reference` is the plain PyTorch version of K2 on the
  kernel's operands: per image and view, the dense weights of the crop
  window, the crop contraction at fp32 and a clip, the gated color
  jitter, the gated grayscale.
- :func:`two_view` runs the plain version for CPU tensors, launches K2
  for CUDA tensors, and raises otherwise: nothing falls back.
  :data:`LAUNCHES` counts its launches.
- :func:`fused_two_view` is the entry point: both views' scalars packed
  from pre-drawn parameters, one K2 launch, then the blur tail (every
  view blurred, selected by its gate, clipped).  The blur was plain XLA
  outside the Pallas kernel, and it is a grouped cuDNN conv here.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from byol_tpu_torch.data import device_augment
from byol_tpu_torch.ops import common

# per-view scalar vectors of the kernel (crop, prm); gates ride as 0/1 fp32
_Y0, _X0, _CH, _CW, _FLIP = range(5)
_NCROP = 5
_JITTER, _FB, _FC, _FS, _THETA, _GRAY = range(6)
_NPARAM = 6

# jax.image's degenerate-weight threshold (1000 * fp32 eps)
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)

# kernel launches since the count was last set to 0 (only the wrapper's
# launch adds to it)
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P]
MAX_TAPS = 16                # the kernel's band window (kMaxTaps)
PARTS = 8                    # blocks per view (kParts; the kernel checks)


def rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as one IEEE division (``num / t`` in torch is
    ``num * reciprocal(t)``, an ulp away from jax's division)."""
    return torch.full_like(t, num) / t


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(B, in_size, out_size) resampling weights of one dimension, one
    matrix per (scale, translation) pair: jax's ``compute_weight_mat`` with
    the triangle kernel and antialias, which ``scale_and_translate(...,
    method='bilinear')`` builds.  Every scalar stays fp32."""
    f32 = torch.float32
    dev = scale.device
    inv_scale = rdiv(1.0, scale.to(f32).reshape(-1, 1, 1))
    translation = translation.to(f32).reshape(-1, 1, 1)
    # antialias: widen the kernel when downsampling (scale < 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32, device=dev) + 0.5)
                * inv_scale - translation * inv_scale - 0.5)   # (B, 1, out)
    src = torch.arange(in_size, dtype=f32, device=dev).reshape(1, -1, 1)
    x = (sample_f - src).abs() / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > _WEIGHT_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    # zero the samples that fall wholly outside the input
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, 0.0)


class CropWindow(NamedTuple):
    """A view's crop window for a batch: (B,) fp32 tensors, the flip gate
    as 0/1 (``ViewParams`` carries the same fields)."""

    y0: torch.Tensor
    x0: torch.Tensor
    ch: torch.Tensor
    cw: torch.Tensor
    flip: torch.Tensor


def crop_weight_mats(p, h: int, w: int,
                     size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view's crop windows (a ``CropWindow`` or ``ViewParams``) as
    ``wy`` (B, h, size) and ``wx`` (B, w, size), the flip folded into
    ``wx``'s column order (exact: a column permutation commutes with the
    contraction and the clip)."""
    sy, sx = rdiv(size, p.ch), rdiv(size, p.cw)
    wy = _weight_mat(h, size, sy, -p.y0 * sy)
    wx = _weight_mat(w, size, sx, -p.x0 * sx)
    wx = torch.where(p.flip.reshape(-1, 1, 1) > 0.5, wx.flip(2), wx)
    return wy, wx


def band_taps(in_size: int, out_size: int) -> int:
    """The band window: source indices per output index that hold every
    non-zero tap of a window inside the image (extent <= in_size, so
    kernel_scale <= max(1, in_size / out_size))."""
    kernel_scale = max(1.0, in_size / out_size)
    return min(in_size, math.floor(2 * kernel_scale) + 3)


def crop_bands(in_size: int, out_size: int, scale: torch.Tensor,
               translation: torch.Tensor, taps: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_weight_mat` as bands: ``first`` (B, out_size) int64 and
    ``weights`` (B, out_size, taps) fp32, the weight of source index
    ``first + t`` in column ``t`` (zero where the triangle is).  The same
    fp32 operations in the same order as the dense matrix, but the column
    total summed over the window in tap order, as K2 sums it; the window
    ``[first, first + taps)`` lies inside ``[0, in_size)``."""
    f32 = torch.float32
    inv_scale = rdiv(1.0, scale.to(f32).reshape(-1, 1))
    translation = translation.to(f32).reshape(-1, 1)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32, device=scale.device)
                 + 0.5) * inv_scale - translation * inv_scale - 0.5)
    first = torch.floor(sample_f - kernel_scale).long().clamp(
        0, in_size - taps)
    src = first.unsqueeze(-1) + torch.arange(taps, device=scale.device)
    x = (sample_f.unsqueeze(-1) - src.to(f32)).abs() / kernel_scale.unsqueeze(
        -1)
    weights = torch.clamp(1 - x.abs(), min=0.0)
    total = weights[..., 0]
    for t in range(1, taps):
        total = total + weights[..., t]
    total = total.unsqueeze(-1)
    weights = torch.where(total.abs() > _WEIGHT_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return first, torch.where(inside.unsqueeze(-1), weights, 0.0)


def crop_window_bands(p, h: int, w: int, size: int):
    """:func:`crop_weight_mats` as bands: ``(row_first, row_weights,
    col_first, col_weights)``, the flip folded into the columns' order."""
    sy, sx = rdiv(size, p.ch), rdiv(size, p.cw)
    ry = crop_bands(h, size, sy, -p.y0 * sy, band_taps(h, size))
    cf, cwt = crop_bands(w, size, sx, -p.x0 * sx, band_taps(w, size))
    flip = p.flip.reshape(-1, 1) > 0.5
    return (*ry, torch.where(flip, cf.flip(1), cf),
            torch.where(flip.unsqueeze(-1), cwt.flip(1), cwt))


def view_kernel_inputs(p: device_augment.ViewParams):
    """One view's kernel operands ``(crop, prm)`` and the blur gate and
    sigma the tail consumes."""
    crop = torch.stack([p.y0, p.x0, p.ch, p.cw, p.flip], dim=1)
    prm = torch.stack([p.jitter, p.fb, p.fc, p.fs, p.theta, p.gray], dim=1)
    return crop, prm, p.blur, p.sigma


def crop_contract(images: torch.Tensor, wy: torch.Tensor,
                  wx: torch.Tensor) -> torch.Tensor:
    """``sum_i sum_j wy[n,v,i,a] x[n,i,j,c] wx[n,v,j,b]`` at fp32, the
    height first: (B, H, W, C) x (B, V, H, S) x (B, V, W, S) -> (B, V, S,
    S, C), contiguous."""
    t = torch.einsum("nhwc,nvha->nvawc", images, wy)
    return torch.einsum("nvawc,nvwb->nvabc", t, wx).contiguous()


def two_view_reference(images: torch.Tensor, crop: torch.Tensor,
                       prm: torch.Tensor, *, size: int, hue: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 on its operands: both pre-blur views of every
    image, the crop windows as dense weights."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    _, h, w, _ = images.shape
    wy, wx = crop_weight_mats(CropWindow(*crop.reshape(-1, _NCROP).unbind(1)),
                              h, w, size)
    b = images.shape[0]
    wy, wx = wy.reshape(b, 2, h, size), wx.reshape(b, 2, w, size)
    crop = crop_contract(x, wy, wx).clamp(0.0, 1.0)
    s, c = crop.shape[2], crop.shape[4]
    v = crop.reshape(2 * b, s, s, c)
    pr = prm.reshape(2 * b, _NPARAM)
    gate = lambda k: pr[:, k].reshape(-1, 1, 1, 1) > 0.5
    v = torch.where(gate(_JITTER), device_augment.apply_color_jitter(
        v, pr[:, _FB], pr[:, _FC], pr[:, _FS], pr[:, _THETA], hue=hue), v)
    v = torch.where(gate(_GRAY), device_augment.apply_grayscale(v), v)
    v = v.reshape(b, 2, s, s, c)
    return v[:, 0].contiguous(), v[:, 1].contiguous()


def _check(images, crop, prm, size) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"two_view: images must be (B, H, W, 3), got "
                         f"{tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"two_view: images must be uint8 or float32, got "
                         f"{images.dtype}")
    b, h, w, _ = images.shape
    for name, t, shape in (("crop", crop, (b, 2, _NCROP)),
                           ("prm", prm, (b, 2, _NPARAM))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != images.device):
            raise ValueError(
                f"two_view: {name} must be float32 {shape} on "
                f"{images.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if size < 1 or b < 1:
        raise ValueError(f"two_view: empty batch or view size {size}")
    taps = max(band_taps(h, size), band_taps(w, size))
    if taps > MAX_TAPS:
        raise ValueError(
            f"two_view: {h}x{w} -> {size} needs bands of {taps} taps; the "
            f"kernel takes up to {MAX_TAPS} (a downsampling ratio below "
            f"{(MAX_TAPS - 2) / 2})")


def two_view(images: torch.Tensor, crop: torch.Tensor, prm: torch.Tensor,
             *, size: int, hue: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (B, H, W, 3) uint8 or fp32 [0, 1] images, ``crop`` (B, 2, 5)
    windows inside the image and ``prm`` (B, 2, 6) -> two (B, size, size,
    3) fp32 views, contiguous NHWC (channels_last NCHW memory)."""
    global LAUNCHES
    _check(images, crop, prm, size)
    if images.device.type == "cpu":
        return two_view_reference(images, crop, prm, size=size, hue=hue)
    if images.device.type != "cuda":
        raise ValueError(f"two_view: no kernel for device {images.device}")
    b, h, w, _ = images.shape
    images, crop, prm = (t.contiguous() for t in (images, crop, prm))
    o1, o2 = (torch.empty((b, size, size, 3), dtype=torch.float32,
                          device=images.device) for _ in range(2))
    part_sum = torch.empty((b, 2, PARTS), dtype=torch.float64,
                           device=images.device)
    err = common.entry("byol_two_view", _ARGTYPES)(
        images.data_ptr(), int(images.dtype == torch.uint8), crop.data_ptr(),
        prm.data_ptr(), o1.data_ptr(), o2.data_ptr(), part_sum.data_ptr(),
        PARTS, b, h, w, size, band_taps(h, size), band_taps(w, size), int(hue),
        torch.cuda.current_stream(images.device).cuda_stream)
    common.check(err, "two_view")
    LAUNCHES += 1
    return o1, o2


def fused_two_view(images: torch.Tensor, size: int,
                   views: Sequence[device_augment.ViewParams], *,
                   strength: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused counterpart of ``device_augment.two_view`` on the same
    draws (``views``, on the images' device): one K2 launch for both views
    of every image, then the blur tail."""
    per_view = [view_kernel_inputs(p) for p in views]
    crop, prm = (torch.stack([per_view[0][i], per_view[1][i]], dim=1)
                 for i in range(2))
    pre = two_view(images, crop, prm, size=size, hue=0.2 * strength > 0)
    kblur = int(0.1 * size)

    def tail(v_pre, gate, sigma):
        blurred = device_augment.apply_gaussian_blur(sigma, v_pre, kblur)
        return torch.where(gate.reshape(-1, 1, 1, 1) > 0.5, blurred,
                           v_pre).clamp(0.0, 1.0)

    v1, v2 = (tail(v, pv[2], pv[3]) for v, pv in zip(pre, per_view))
    return v1, v2
