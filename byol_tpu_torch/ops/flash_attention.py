"""Flash attention: the Hopper kernel, its plain version, the wrapper.

Counterpart of byol_tpu/ops/flash_attention.py (the Pallas ``_flash_kernel``
for the TPU).  The CUDA kernel is ``csrc/flash_attention.cu``; its header
states the bound at the serving shape and what the design does about it.

- :func:`flash_attention_reference` is the plain PyTorch version of the same
  function: fp32 scores, fp32 softmax, ``p`` cast to ``v``'s dtype, ``p.v``
  accumulated in fp32, output in the input dtype.  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
- :func:`flash_attention` dispatches on the device: a CPU tensor goes to the
  plain version, a CUDA tensor to the kernel.  A build or launch failure
  raises; nothing falls back.
- :func:`launch_plan` decides, from ``(B*H, S)`` and the card's SM count
  alone, how the bf16 kernel cuts the query rows of a head over blocks;
  :func:`plan_rows` lists the rows each block takes.
- :data:`LAUNCHES` counts kernel launches, so a run can show that its main
  path went through the kernel.

Forward only, as the reference (its pallas_call has no custom_vjp, so no
TPU kernel has a backward to port): inputs that require a gradient are
refused, and training runs ``--attn-impl dense`` or ``ring``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from byol_tpu_torch.ops import common

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535          # batch * heads rides the grid's y dimension
# the bf16 kernel's geometry (csrc/flash_attention.cu)
RESIDENT_MAX_SEQ = 256       # K/V of a whole head stay in shared memory
RING_ROWS = 128              # query rows of a block past that (8 warps x 16)
MAX_SPLITS = 4               # blocks a resident head's query rows may take
GROUP_ROWS = 32              # query rows of a resident warp (2 m-tiles)

# kernel launches since the count was last set to 0 (only the wrapper's
# launch adds to it)
LAUNCHES = 0

_ENTRY = "byol_flash_attention_fwd"


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) x3 -> (B, H, S, D), the kernel's function in PyTorch."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


class Plan(NamedTuple):
    """How the bf16 kernel covers one head: ``blocks_per_head`` work items
    (blocks on the ring) of ``rows_per_block`` query rows (resident: whole
    32-row groups, a warp's two 16-row m-tiles; 128 on the ring), K/V
    ``resident`` in shared memory or streamed through the ring."""

    resident: bool
    blocks_per_head: int
    rows_per_block: int


def launch_plan(bh: int, s: int, sms: int) -> Plan:
    """The bf16 kernel's cut of the query rows for ``bh`` heads of ``s``
    rows on a card of ``sms`` SMs (the persistent grid's blocks).  Up to
    ``RESIDENT_MAX_SEQ`` a work item is a whole head, unless ``bh`` heads
    are fewer than the SMs: then each head's 32-row groups are split over
    up to ``MAX_SPLITS`` items (each loads all of K/V, mostly from L2).
    Past it, blocks of ``RING_ROWS`` rows."""
    if s <= RESIDENT_MAX_SEQ:
        groups = -(-s // GROUP_ROWS)
        splits = max(1, min(MAX_SPLITS, groups, -(-sms // bh)))
        rows = -(-groups // splits) * GROUP_ROWS
        return Plan(True, -(-s // rows), rows)
    return Plan(False, -(-s // RING_ROWS), RING_ROWS)


def plan_rows(plan: Plan, s: int) -> List[Tuple[int, int]]:
    """The query rows ``[start, stop)`` of each work item of one head, as
    the kernel derives them from the item's index and
    ``rows_per_block``."""
    r = plan.rows_per_block
    return [(i * r, min(s, (i + 1) * r)) for i in range(plan.blocks_per_head)]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes (B, H, S, D), got "
                         f"{tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} {tuple(t.shape)} {t.dtype} on "
                f"{t.device} does not match q {tuple(q.shape)} {q.dtype} on "
                f"{q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported; "
                         f"the kernel takes {DTYPES}")
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not supported; the "
                         f"kernel takes {HEAD_DIMS}")
    if s < 1 or b * h < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} out of "
                         f"range (1 <= B*H <= {_MAX_GRID_Y}, S >= 1)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only: the JAX kernel it ports has "
            "no backward (its pallas_call has no custom_vjp); train with "
            "--attn-impl dense|ring")


def _rows_16b_aligned(t: torch.Tensor) -> bool:
    elems = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(t.stride(i) % elems == 0 for i in range(3)))


_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA card: the bf16 kernel's persistent grid, and the
    count :func:`launch_plan` fills."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) x3 -> (B, H, S, D); same contract as dense_attention.

    CUDA tensors launch the kernel (any (b, h, s) strides, contiguous head
    dim); CPU tensors run :func:`flash_attention_reference`.  Both refuse
    what the kernel does not take (dtype, head dim, gradients)."""
    global LAUNCHES
    _check(q, k, v)       # one input contract on both devices
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, s, d = q.shape
    sms = sm_count(q.device)
    plan = launch_plan(b * h, s, sms)
    if q.dtype == torch.bfloat16:
        # the bf16 kernel stages rows with 16-byte copies
        q, k, v = (t if _rows_16b_aligned(t)
                   else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    err = common.entry(_ENTRY, _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, s, d, int(q.dtype == torch.bfloat16), plan.rows_per_block, sms,
        torch.cuda.current_stream(q.device).cuda_stream)
    common.check(err, "flash_attention")
    LAUNCHES += 1
    return out
