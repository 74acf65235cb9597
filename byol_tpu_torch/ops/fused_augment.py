"""Fused uint8 -> two-view augmentation: the Hopper kernel K2, its plain
version, the wrapper, and the weight build around it.

Counterpart of byol_tpu/ops/fused_augment.py (the Pallas
``_two_view_kernel``).  The CUDA kernel is ``csrc/fused_augment.cu``; its
header states its bound at the ResNet-50 training shape and what the
design does about it.

- :func:`_weight_mat` / :func:`crop_weight_mats`: a crop window as the
  (in, size) antialiased triangle weights jax's ``scale_and_translate``
  builds, batched over images, fp32 throughout; the horizontal flip is a
  column permutation of ``wx``.  :func:`view_kernel_inputs` packs one
  view's kernel operands, ``prm`` in the ``_JITTER, _FB, _FC, _FS,
  _THETA, _GRAY`` layout.
- :func:`two_view_reference` is the plain PyTorch version of K2: per image
  and view, the crop contraction at fp32 and a clip, the gated color
  jitter, the gated grayscale.
- :func:`two_view` runs the plain version for CPU tensors, launches K2
  for CUDA tensors, and raises otherwise: nothing falls back.
  :data:`LAUNCHES` counts its launches.
- :func:`fused_two_view` is the entry point: both views' weights built on
  the device from pre-drawn parameters, one K2 launch, then the blur tail
  (every view blurred, selected by its gate, clipped).  The blur was plain
  XLA outside the Pallas kernel, and it is a grouped cuDNN conv here.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from byol_tpu_torch.data import device_augment
from byol_tpu_torch.ops import common

# per-view scalar vector of the kernel (prm); gates ride as 0/1 fp32
_JITTER, _FB, _FC, _FS, _THETA, _GRAY = range(6)
_NPARAM = 6

# jax.image's degenerate-weight threshold (1000 * fp32 eps)
_WEIGHT_EPS = 1000.0 * float(np.finfo(np.float32).eps)

# kernel launches since the count was last set to 0 (only the wrapper's
# launch adds to it)
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_PARTS = 4                   # blocks per view (kParts in the kernel)


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


def crop_weight_mats(p: device_augment.ViewParams, h: int, w: int,
                     size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view's crop windows as ``wy`` (B, h, size) and ``wx`` (B, w,
    size), the flip folded into ``wx``'s column order (exact: a column
    permutation commutes with the contraction and the clip)."""
    sy, sx = rdiv(size, p.ch), rdiv(size, p.cw)
    wy = _weight_mat(h, size, sy, -p.y0 * sy)
    wx = _weight_mat(w, size, sx, -p.x0 * sx)
    wx = torch.where(p.flip.reshape(-1, 1, 1) > 0.5, wx.flip(2), wx)
    return wy, wx


def view_kernel_inputs(p: device_augment.ViewParams, h: int, w: int,
                       size: int):
    """One view's kernel operands ``(wy, wx, prm)`` and the blur gate and
    sigma the tail consumes."""
    wy, wx = crop_weight_mats(p, h, w, size)
    prm = torch.stack([p.jitter, p.fb, p.fc, p.fs, p.theta, p.gray], dim=1)
    return wy, wx, prm, p.blur, p.sigma


def crop_contract(images: torch.Tensor, wy: torch.Tensor,
                  wx: torch.Tensor) -> torch.Tensor:
    """``sum_i sum_j wy[n,v,i,a] x[n,i,j,c] wx[n,v,j,b]`` at fp32, the
    height first: (B, H, W, C) x (B, V, H, S) x (B, V, W, S) -> (B, V, S,
    S, C), contiguous."""
    t = torch.einsum("nhwc,nvha->nvawc", images, wy)
    return torch.einsum("nvawc,nvwb->nvabc", t, wx).contiguous()


def two_view_reference(images: torch.Tensor, wy: torch.Tensor,
                       wx: torch.Tensor, prm: torch.Tensor, *, hue: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: both pre-blur views of every image."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    crop = crop_contract(x, wy, wx).clamp(0.0, 1.0)
    b, _, s, _, c = crop.shape
    v = crop.reshape(2 * b, s, s, c)
    pr = prm.reshape(2 * b, _NPARAM)
    gate = lambda k: pr[:, k].reshape(-1, 1, 1, 1) > 0.5
    v = torch.where(gate(_JITTER), device_augment.apply_color_jitter(
        v, pr[:, _FB], pr[:, _FC], pr[:, _FS], pr[:, _THETA], hue=hue), v)
    v = torch.where(gate(_GRAY), device_augment.apply_grayscale(v), v)
    v = v.reshape(b, 2, s, s, c)
    return v[:, 0].contiguous(), v[:, 1].contiguous()


def _check(images, wy, wx, prm) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"two_view: images must be (B, H, W, 3), got "
                         f"{tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"two_view: images must be uint8 or float32, got "
                         f"{images.dtype}")
    b, h, w, _ = images.shape
    size = wy.shape[-1] if wy.dim() == 4 else -1
    for name, t, shape in (("wy", wy, (b, 2, h, size)),
                           ("wx", wx, (b, 2, w, size)),
                           ("prm", prm, (b, 2, _NPARAM))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or t.device != images.device):
            raise ValueError(
                f"two_view: {name} must be float32 {shape} on "
                f"{images.device}; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if size < 1 or b < 1:
        raise ValueError(f"two_view: empty batch or view size {size}")


def two_view(images: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor,
             prm: torch.Tensor, *, hue: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: (B, H, W, 3) uint8 or fp32 [0, 1] images, ``wy`` (B, 2, H, S),
    ``wx`` (B, 2, W, S) and ``prm`` (B, 2, 6) -> two (B, S, S, 3) fp32
    views, contiguous NHWC (channels_last NCHW memory)."""
    global LAUNCHES
    _check(images, wy, wx, prm)
    if images.device.type == "cpu":
        return two_view_reference(images, wy, wx, prm, hue=hue)
    if images.device.type != "cuda":
        raise ValueError(f"two_view: no kernel for device {images.device}")
    b, h, w, _ = images.shape
    s = wy.shape[-1]
    images, wy, wx, prm = (t.contiguous() for t in (images, wy, wx, prm))
    o1, o2 = (torch.empty((b, s, s, 3), dtype=torch.float32,
                          device=images.device) for _ in range(2))
    part_sum = torch.empty((b, 2, _PARTS), dtype=torch.float64,
                           device=images.device)
    err = common.entry("byol_two_view", _ARGTYPES)(
        images.data_ptr(), int(images.dtype == torch.uint8), wy.data_ptr(),
        wx.data_ptr(), prm.data_ptr(), o1.data_ptr(), o2.data_ptr(),
        part_sum.data_ptr(), b, h, w, s, int(hue),
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
    _, h, w, _ = images.shape
    per_view = [view_kernel_inputs(p, h, w, size) for p in views]
    wy, wx, prm = (torch.stack([per_view[0][i], per_view[1][i]], dim=1)
                   for i in range(3))
    pre = two_view(images, wy, wx, prm, hue=0.2 * strength > 0)
    kblur = int(0.1 * size)

    def tail(v_pre, gate, sigma):
        blurred = device_augment.apply_gaussian_blur(sigma, v_pre, kblur)
        return torch.where(gate.reshape(-1, 1, 1, 1) > 0.5, blurred,
                           v_pre).clamp(0.0, 1.0)

    v1, v2 = (tail(v, pv[3], pv[4]) for v, pv in zip(pre, per_view))
    return v1, v2
