"""Train-mode BatchNorm fused with its ReLU and residual add, on
channels-last bf16 activations: the CUDA kernels of ``csrc/batch_norm.cu``,
their plain version, the wrapper and the rule that picks them.

No TPU kernel is replaced: on the TPU, XLA fuses the norm, the ReLU, the
add and the casts into the convolutions' neighbouring fusions, so the JAX
package has no BatchNorm kernel.  The port ran them as separate PyTorch
ops over fp32 copies; the kernels read the bf16 conv output directly, keep
every statistic in fp32, and write the result once (the header of the
``.cu`` file states the bytes and the design).

- :func:`fusable` is the dispatch rule: a CUDA tensor with 4 dims in
  channels-last layout, bf16, channels a multiple of 8.
  :class:`~byol_tpu_torch.models.layers.BatchNorm` takes the kernels for
  such an input in train mode when its statistics are not synced, and its
  own path otherwise.
- :func:`train_norm` is ``relu?((x - mean) * w * rstd + bias (+
  residual))`` with the batch's mean and biased variance, the running
  statistics moved by flax's rule when ``update`` is set; stored in
  ``out_dtype`` (bf16 only where every consumer casts to bf16 first, so
  the value is the one today's fp32 result rounds to), and with
  ``copy_dtype`` once more as a bf16 copy for the consumers that cast
  (the copy's gradient joins the output's in fp32).  Its gradient is a
  :class:`torch.autograd.Function` whose backward is kernels too; what it
  saves goes through ``ctx.save_for_backward`` (remat's checkpoints and
  ``offload_block_out``'s hooks see it): the bf16 input, the per-channel
  mean and rstd, and with ReLU one byte of "output > 0" bits per 8
  channels (the input's 2 bytes an element plus 1/8, where today's chain
  kept an fp32 input and an fp32 ReLU output).
- CPU tensors run the plain version of the same arithmetic
  (:func:`forward_reference`, :func:`backward_reference`); a CUDA tensor
  runs the kernels or raises: nothing falls back.
- :data:`LAUNCHES` counts the kernel calls (one a fused forward: stats,
  finalize, apply; one a backward: sums, finalize, apply);
  :data:`UNFUSED_CUDA_CALLS` counts BatchNorm calls on a CUDA tensor that
  took the module's own path (2-D heads, eval, synced, fp32 nets).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from byol_tpu_torch.core.precision import at_least_fp32
from byol_tpu_torch.ops import common

# fused forward and backward calls that launched the kernels
LAUNCHES = 0
# BatchNorm calls on a CUDA tensor that took the module's own path
UNFUSED_CUDA_CALLS = 0

VEC = 8                      # channels a thread holds (kVec)
THREADS = 256                # threads a block (kThreads)
TARGET_BLOCKS = 2112         # 2 waves of 8 blocks on each of 132 SMs
MIN_STEPS = 4                # row steps a thread makes at least

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_FORWARD_ARGTYPES = ([_P] * 5 + [_I, _P, _I] + [_P] * 7
                     + [_L, _I, _I, _L, _I] + [_F] * 3 + [_P])
_BACKWARD_ARGTYPES = [_P, _I] + [_P] * 13 + [_L, _I, _I, _L, _P]

_CL = torch.channels_last


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lives on the card (the dispatch rule's device test)."""
    return x.is_cuda


def fusable(x: torch.Tensor) -> bool:
    """Whether the kernels take ``x``: a CUDA (N, C, H, W) bf16 tensor in
    channels-last layout, C a multiple of 8, not empty."""
    return (on_card(x) and x.dim() == 4 and x.dtype == torch.bfloat16
            and x.shape[1] % VEC == 0 and x.numel() > 0
            and x.is_contiguous(memory_format=_CL))


def grid(rows: int, channels: int) -> Tuple[int, int]:
    """``(parts, chunk)``: the rows cut into ``parts`` chunks of ``chunk``
    (the last one shorter, not empty), about :data:`TARGET_BLOCKS` blocks
    over the channel groups, each thread making at least
    :data:`MIN_STEPS` row steps where the rows allow."""
    vecs = channels // VEC
    lanes = min(32, vecs & -vecs)
    groups, step = vecs // lanes, THREADS // lanes
    steps = -(-rows // step)
    parts = max(1, min(-(-TARGET_BLOCKS // groups), steps // MIN_STEPS))
    chunk = -(-steps // parts) * step
    return -(-rows // chunk), chunk


def forward_reference(x, weight, bias, residual, running_mean, running_var,
                      *, relu: bool, out_dtype: torch.dtype,
                      copy_dtype: Optional[torch.dtype], momentum: float,
                      eps: float, update: bool):
    """The kernels' forward in plain PyTorch, in at least fp32: ``(out,
    copy, mask, mean, rstd)``; ``copy`` the output rounded to
    ``copy_dtype`` (None without one), ``mask`` the bool "output > 0" of
    the ReLU (NaN passes) or None."""
    xf = at_least_fp32(x)
    dims = [0, 2, 3]
    shape = (1, -1, 1, 1)
    mean = xf.mean(dims)
    xc = xf - mean.view(shape)
    var = (xc * xc).mean(dims)
    rstd = torch.rsqrt(var + eps)
    y = xc * (weight * rstd).view(shape) + bias.view(shape)
    if residual is not None:
        y = y + residual
    mask = None
    if relu:
        mask = ~(y <= 0)
        y = torch.where(mask, y, torch.zeros_like(y))
    if update:
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean, alpha=1.0 - momentum)
            running_var.mul_(momentum).add_(var, alpha=1.0 - momentum)
    copy = None if copy_dtype is None else y.to(copy_dtype)
    return y.to(out_dtype), copy, mask, mean, rstd


def backward_reference(grad, grad_copy, x, weight, mean, rstd, mask,
                       residual: bool):
    """The kernels' backward in plain PyTorch: ``(dx, dres, dweight,
    dbias)``, ``dres`` None without a residual; ``grad_copy`` (or None)
    the copy's gradient, added to ``grad`` in at least fp32."""
    xf = at_least_fp32(x)
    dims = [0, 2, 3]
    shape = (1, -1, 1, 1)
    g = grad.to(xf.dtype)
    if grad_copy is not None:
        g = g + grad_copy.to(xf.dtype)
    if mask is not None:
        g = torch.where(mask, g, torch.zeros_like(g))
    xc = xf - mean.view(shape)
    s, d = g.sum(dims), (g * xc).sum(dims)
    m = x.numel() // x.shape[1]
    a = weight * rstd
    dx = a.view(shape) * (g - (s / m).view(shape)
                          - xc * (rstd * rstd * d / m).view(shape))
    return dx.to(x.dtype), (g if residual else None), d * rstd, s


def _check(x, weight, bias, residual, running_mean, running_var) -> None:
    if not fusable(x):
        raise ValueError(
            f"batch_norm: the kernels take a CUDA (N, C, H, W) bf16 "
            f"channels-last tensor, C a multiple of {VEC}; got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"batch_norm: {name} must be a contiguous "
                             f"float32 ({c},) on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if residual is not None and (
            residual.dtype != torch.float32 or residual.shape != x.shape
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=_CL)):
        raise ValueError("batch_norm: the residual must be a float32 "
                         f"channels-last {tuple(x.shape)} on {x.device}")
    for t in (x, residual):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("batch_norm: the kernels need 16-byte aligned "
                             "rows")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(x, weight, bias, residual, running_mean, running_var, *,
             relu: bool, out_dtype: torch.dtype,
             copy_dtype: Optional[torch.dtype], momentum: float, eps: float,
             update: bool, with_mask: bool):
    """``(out, copy, mask, mean, rstd)``; ``mask`` only with ReLU and
    ``with_mask`` (a backward will read it)."""
    global LAUNCHES
    if x.device.type == "cpu":
        out, copy, mask, mean, rstd = forward_reference(
            x, weight, bias, residual, running_mean, running_var, relu=relu,
            out_dtype=out_dtype, copy_dtype=copy_dtype, momentum=momentum,
            eps=eps, update=update)
        return out, copy, (mask if with_mask else None), mean, rstd
    _check(x, weight, bias, residual, running_mean, running_var)
    if out_dtype not in (torch.bfloat16, torch.float32) or copy_dtype not in (
            None, torch.bfloat16):
        raise ValueError(f"batch_norm: no kernel stores {out_dtype} with a "
                         f"{copy_dtype} copy")
    n, c, h, w = x.shape
    rows = n * h * w
    parts, chunk = grid(rows, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty_like(x, dtype=out_dtype, memory_format=_CL)
    copy = (None if copy_dtype is None else
            torch.empty_like(x, dtype=copy_dtype, memory_format=_CL))
    mask = (torch.empty((n, h, w, c // VEC), dtype=torch.uint8,
                        device=x.device) if relu and with_mask else None)
    mean, rstd = torch.empty(c, **f32), torch.empty(c, **f32)
    part = torch.empty((2, parts, c), **f32)
    err = common.entry("byol_bn_forward", _FORWARD_ARGTYPES)(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), _ptr(residual),
        out.data_ptr(), int(out_dtype == torch.bfloat16), _ptr(copy),
        int(relu), _ptr(mask), mean.data_ptr(), rstd.data_ptr(),
        running_mean.data_ptr(), running_var.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), rows, c, parts, chunk, int(update), momentum,
        1.0 - momentum, eps, common.stream(x))
    common.check(err, "batch_norm forward")
    LAUNCHES += 1
    return out, copy, mask, mean, rstd


def _backward(grad, grad_copy, x, weight, mean, rstd, mask, residual: bool):
    """``(dx, dres, dweight, dbias)``, ``dres`` None unless ``residual``;
    ``grad`` and ``grad_copy`` the output's and the copy's gradients (at
    least one of them not None)."""
    global LAUNCHES
    if grad is None:
        grad, grad_copy = grad_copy, None
    if x.device.type == "cpu":
        return backward_reference(grad, grad_copy, x, weight, mean, rstd,
                                  mask, residual)
    if grad.dtype not in (torch.bfloat16, torch.float32) or (
            grad_copy is not None and grad_copy.dtype != torch.bfloat16):
        raise ValueError(f"batch_norm: no kernel reads a {grad.dtype} "
                         "gradient with a "
                         f"{getattr(grad_copy, 'dtype', None)} one")
    grad = grad.contiguous(memory_format=_CL)
    if grad_copy is not None:
        grad_copy = grad_copy.contiguous(memory_format=_CL)
    n, c, h, w = x.shape
    rows = n * h * w
    parts, chunk = grid(rows, c)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=_CL)
    dres = (torch.empty_like(x, dtype=torch.float32, memory_format=_CL)
            if residual else None)
    dweight, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
    coef = torch.empty((3, c), **f32)
    part = torch.empty((2, parts, c), **f32)
    err = common.entry("byol_bn_backward", _BACKWARD_ARGTYPES)(
        grad.data_ptr(), int(grad.dtype == torch.bfloat16), _ptr(grad_copy),
        x.data_ptr(), _ptr(mask), mean.data_ptr(), rstd.data_ptr(),
        weight.data_ptr(), dx.data_ptr(), _ptr(dres), dweight.data_ptr(),
        dbias.data_ptr(), coef.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), rows, c, parts, chunk, common.stream(x))
    common.check(err, "batch_norm backward")
    LAUNCHES += 1
    return dx, dres, dweight, dbias


class _TrainNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                relu, out_dtype, copy_dtype, momentum, eps, update):
        out, copy, mask, mean, rstd = _forward(
            x, weight, bias, residual, running_mean, running_var, relu=relu,
            out_dtype=out_dtype, copy_dtype=copy_dtype, momentum=momentum,
            eps=eps, update=update, with_mask=True)
        ctx.save_for_backward(x, weight, mean, rstd, mask)
        ctx.residual = residual is not None
        # an unused copy's gradient stays None: nothing to read
        ctx.set_materialize_grads(False)
        return out if copy is None else (out, copy)

    @staticmethod
    def backward(ctx, grad, grad_copy=None):
        if grad is None and grad_copy is None:
            return (None,) * 12
        x, weight, mean, rstd, mask = ctx.saved_tensors
        dx, dres, dweight, dbias = _backward(
            grad, grad_copy, x, weight, mean, rstd, mask,
            ctx.residual and ctx.needs_input_grad[3])
        return (dx, dweight, dbias, dres) + (None,) * 8


def train_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               residual: Optional[torch.Tensor] = None, relu: bool = False,
               out_dtype: torch.dtype = torch.float32,
               copy_dtype: Optional[torch.dtype] = None,
               momentum: float = 0.9, eps: float = 1e-5,
               update: bool = True):
    """Train-mode BatchNorm of ``x`` over its batch, then ``+ residual``
    and ReLU where asked, stored as ``out_dtype``; with ``copy_dtype``,
    ``(out, copy)``, the copy the output rounded to it (for consumers that
    cast it so: the copy is the value their cast would give, and its
    gradient is added to the output's in fp32, as autograd adds the
    cast's).  The running statistics move in place when ``update`` is set.
    Kernels for a CUDA tensor, the plain version for a CPU one;
    differentiable in ``x``, ``weight``, ``bias`` and ``residual``."""
    if residual is not None and x.device.type != "cpu":
        residual = residual.float().contiguous(memory_format=_CL)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, residual)):
        return _TrainNorm.apply(x, weight, bias, residual, running_mean,
                                running_var, relu, out_dtype, copy_dtype,
                                momentum, eps, update)
    out, copy, _, _, _ = _forward(
        x, weight, bias, residual, running_mean, running_var, relu=relu,
        out_dtype=out_dtype, copy_dtype=copy_dtype, momentum=momentum,
        eps=eps, update=update, with_mask=False)
    return out if copy is None else (out, copy)
