"""Fused LARS+EMA weight update: the Hopper kernels K1a and K1b, their plain
versions, the wrappers, and the flat segmented layout they run on.

Counterpart of byol_tpu/ops/fused_update.py (the Pallas
``_segment_norms_kernel`` and ``_fused_apply_kernel``).  The CUDA kernels
are ``csrc/fused_update.cu``; its header states their bounds at the
ResNet-50 shape and what the design does about them.

- :class:`SegmentMap` / :func:`build_segment_map`: every parameter leaf is
  one segment of a flat fp32 buffer, zero-padded to whole 128-lane rows;
  the padding is inert under every norm and every elementwise step.
  :func:`pack_flat` / :func:`unpack_flat` move leaves in and out.
- :class:`FusedLayout`: the segment map as device tensors (row -> segment,
  segment row starts, weight decay and exclusion per segment), built once.
- :func:`segment_norms` (K1a): per-segment ``|p|`` and ``|g + wd p|`` and
  the applied trust scale; deterministic (no atomics).
- :func:`fused_apply` (K1b): wd fold-in, trust scale, momentum tick, param
  write and EMA tick, in place on p, m and t.
- :func:`fused_lars_ema_update_buffers` runs both on the flat buffers (the
  counterpart of ``_fused_update_buffers``).

Each wrapper runs its plain version (``*_reference``) for CPU tensors,
launches its kernel for CUDA tensors, and raises otherwise: nothing falls
back.  ``SEGMENT_NORMS_LAUNCHES`` / ``FUSED_APPLY_LAUNCHES`` count kernel
launches, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from byol_tpu_torch.ops import common
from byol_tpu_torch.optim import lars as lars_lib

LANES = 128

# kernel launches since the count was last set to 0 (only the wrappers'
# launches add to them)
SEGMENT_NORMS_LAUNCHES = 0
FUSED_APPLY_LAUNCHES = 0


# ---------------------------------------------------------------------------
# segment map: leaf -> [start, end) offsets in the flat buffer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentMap:
    """``sizes[i]`` real elements of leaf i live at ``[starts[i], starts[i] +
    sizes[i])``; the tail up to ``starts[i] + padded[i]`` is zero padding.
    Segments tile the buffer: ``starts[i+1] == starts[i] + padded[i]``.
    ``adapted[i]`` False: trust ratio 1 and weight decay 0 (bias/BN)."""

    sizes: Tuple[int, ...]
    padded: Tuple[int, ...]
    starts: Tuple[int, ...]
    adapted: Tuple[bool, ...]

    @property
    def total(self) -> int:
        return self.starts[-1] + self.padded[-1] if self.sizes else 0

    @property
    def num_rows(self) -> int:
        return self.total // LANES

    @property
    def num_segments(self) -> int:
        return len(self.sizes)

    def row_segment_ids(self) -> np.ndarray:
        """(num_rows,) int32: the segment of each 128-lane row."""
        return np.repeat(np.arange(self.num_segments, dtype=np.int32),
                         [p // LANES for p in self.padded])


def build_segment_map(sizes: Sequence[int],
                      adapted: Sequence[bool]) -> SegmentMap:
    """One flat segment per leaf, each padded to whole rows."""
    if len(sizes) != len(adapted):
        raise ValueError(f"{len(sizes)} sizes vs {len(adapted)} mask slots")
    if any(s <= 0 for s in sizes):
        raise ValueError(f"empty segment in {sizes}")
    padded = tuple(-(-int(s) // LANES) * LANES for s in sizes)
    starts = tuple(int(x) for x in np.cumsum((0,) + padded[:-1]))
    return SegmentMap(sizes=tuple(int(s) for s in sizes), padded=padded,
                      starts=starts, adapted=tuple(bool(a) for a in adapted))


def segment_map_for(leaves: Sequence[torch.Tensor]) -> SegmentMap:
    """The map of these leaves, with the ndim > 1 exclusion mask."""
    return build_segment_map([t.numel() for t in leaves],
                             lars_lib.default_exclusion_mask(leaves))


def pack_flat(leaves: Sequence[torch.Tensor], seg: SegmentMap) -> torch.Tensor:
    """Ravel + zero-pad each leaf into its segment: a (total,) fp32 buffer."""
    if len(leaves) != seg.num_segments:
        raise ValueError(f"{len(leaves)} leaves vs {seg.num_segments} "
                         "segments")
    buf = torch.zeros(seg.total, dtype=torch.float32,
                      device=leaves[0].device)
    for leaf, start, size in zip(leaves, seg.starts, seg.sizes):
        if leaf.numel() != size:
            raise ValueError(f"leaf has {leaf.numel()} elements, segment "
                             f"map expects {size}")
        buf[start:start + size] = leaf.reshape(-1)
    return buf


def unpack_flat(buf: torch.Tensor, seg: SegmentMap,
                shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """Each segment's real elements as a VIEW of ``buf`` in its shape."""
    flat = buf.reshape(-1)
    return [flat[start:start + size].view(tuple(shape))
            for start, size, shape in zip(seg.starts, seg.sizes, shapes)]


@dataclasses.dataclass(frozen=True)
class FusedLayout:
    """The segment map and the weight decay as device tensors."""

    seg: SegmentMap
    row_seg: torch.Tensor          # (rows,) int32
    seg_row_start: torch.Tensor    # (nseg + 1,) int32
    seg_adapted: torch.Tensor      # (nseg,) int32
    seg_wd: torch.Tensor           # (nseg,) fp32: wd on adapted, else 0

    @classmethod
    def build(cls, seg: SegmentMap, weight_decay: float,
              device) -> "FusedLayout":
        adapted = np.asarray(seg.adapted, bool)
        row_start = np.asarray(seg.starts + (seg.total,), np.int64) // LANES
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(seg=seg, row_seg=to(seg.row_segment_ids()),
                   seg_row_start=to(row_start.astype(np.int32)),
                   seg_adapted=to(adapted.astype(np.int32)),
                   seg_wd=to(np.where(adapted, np.float32(weight_decay),
                                      np.float32(0.0)).astype(np.float32)))


def _check(layout: FusedLayout, *bufs: torch.Tensor) -> None:
    dev = bufs[0].device
    for b in bufs:
        if (b.dtype != torch.float32 or b.numel() != layout.seg.total
                or not b.is_contiguous() or b.device != dev):
            raise ValueError(
                f"fused update: buffers must be contiguous fp32 with "
                f"{layout.seg.total} elements on one device; got "
                f"{b.dtype} {tuple(b.shape)} on {b.device}")
    if layout.row_seg.device != dev:
        raise ValueError(f"fused update: layout on {layout.row_seg.device}, "
                         f"buffers on {dev}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# ---------------------------------------------------------------------------
# K1a: segment norms -> trust scale
# ---------------------------------------------------------------------------

def segment_norms_reference(p: torch.Tensor, g: torch.Tensor,
                            layout: FusedLayout,
                            trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
                            eps: float = lars_lib.LARS_EPS_DEFAULT
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1a: fp32 row partials, float64 segment sums."""
    rows = layout.row_seg.long()
    pr, gr = p.view(-1, LANES), g.view(-1, LANES)
    gp = gr + layout.seg_wd[rows][:, None] * pr
    partial = torch.stack([(pr * pr).sum(dim=1), (gp * gp).sum(dim=1)], 1)
    sums = torch.zeros(layout.seg.num_segments, 2, dtype=torch.float64,
                       device=p.device).index_add_(0, rows, partial.double())
    norms = sums.sqrt().float()
    ratio = lars_lib.trust_ratio_from_norms(norms[:, 0], norms[:, 1],
                                            trust_coefficient, eps)
    scale = torch.where(layout.seg_adapted.bool(), ratio,
                        torch.ones_like(ratio))
    return scale, norms


def segment_norms(p: torch.Tensor, g: torch.Tensor, layout: FusedLayout,
                  trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
                  eps: float = lars_lib.LARS_EPS_DEFAULT
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1a: ``(scale (nseg,), norms (nseg, 2))`` with norms = (|p|,
    |g + wd p|) per segment and scale the applied trust ratio (1 on
    excluded segments)."""
    global SEGMENT_NORMS_LAUNCHES
    _check(layout, p, g)
    if p.device.type == "cpu":
        return segment_norms_reference(p, g, layout, trust_coefficient, eps)
    if p.device.type != "cuda":
        raise ValueError(f"segment_norms: no kernel for device {p.device}")
    seg = layout.seg
    partial = torch.empty((seg.num_rows, 2), dtype=torch.float32,
                          device=p.device)
    norms = torch.empty((seg.num_segments, 2), dtype=torch.float32,
                        device=p.device)
    scale = torch.empty(seg.num_segments, dtype=torch.float32,
                        device=p.device)
    fn = common.entry("byol_segment_norms", [_P] * 9 + [_I, _I, _F, _F, _P])
    err = fn(p.data_ptr(), g.data_ptr(), layout.row_seg.data_ptr(),
             layout.seg_wd.data_ptr(), layout.seg_row_start.data_ptr(),
             layout.seg_adapted.data_ptr(), partial.data_ptr(),
             norms.data_ptr(), scale.data_ptr(), seg.num_rows,
             seg.num_segments, trust_coefficient, eps,
             torch.cuda.current_stream(p.device).cuda_stream)
    common.check(err, "segment_norms")
    SEGMENT_NORMS_LAUNCHES += 1
    return scale, norms


# ---------------------------------------------------------------------------
# K1b: fused apply
# ---------------------------------------------------------------------------

@torch.no_grad()
def fused_apply_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          t: torch.Tensor, scale: torch.Tensor,
                          layout: FusedLayout, *, lr: float, tau: float,
                          momentum_decay: float, ema_pre: bool) -> None:
    """Plain version of K1b, in place on p, m and t."""
    rows = layout.row_seg.long()
    pr, gr, mr, tr = (b.view(-1, LANES) for b in (p, g, m, t))
    u = (gr + layout.seg_wd[rows][:, None] * pr) * scale[rows][:, None]
    mr.mul_(momentum_decay).add_(u)
    src = pr.clone() if ema_pre else pr
    pr.add_(mr, alpha=-lr)
    tr.mul_(tau).add_(src, alpha=1.0 - tau)


def fused_apply(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                t: torch.Tensor, scale: torch.Tensor, layout: FusedLayout, *,
                lr: float, tau: float, momentum_decay: float,
                ema_pre: bool) -> None:
    """K1b, in place: ``u = (g + wd p) scale``; ``m = mu m + u``;
    ``p = p - lr m``; ``t = tau t + (1 - tau) (p, or the old p under
    ema_pre)``.  ``scale`` is K1a's per-segment output."""
    global FUSED_APPLY_LAUNCHES
    _check(layout, p, g, m, t)
    if (scale.shape != (layout.seg.num_segments,) or scale.device != p.device
            or scale.dtype != torch.float32 or not scale.is_contiguous()):
        raise ValueError(f"fused_apply: scale must be contiguous fp32 "
                         f"({layout.seg.num_segments},) on {p.device}; got "
                         f"{scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    if p.device.type == "cpu":
        return fused_apply_reference(p, g, m, t, scale, layout, lr=lr,
                                     tau=tau, momentum_decay=momentum_decay,
                                     ema_pre=ema_pre)
    if p.device.type != "cuda":
        raise ValueError(f"fused_apply: no kernel for device {p.device}")
    fn = common.entry("byol_fused_apply", [_P] * 7 + [_I, _F, _F, _F, _I, _P])
    err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), t.data_ptr(),
             layout.row_seg.data_ptr(), layout.seg_wd.data_ptr(),
             scale.data_ptr(), layout.seg.num_rows, lr, tau,
             momentum_decay, int(ema_pre),
             torch.cuda.current_stream(p.device).cuda_stream)
    common.check(err, "fused_apply")
    FUSED_APPLY_LAUNCHES += 1


# ---------------------------------------------------------------------------
# the whole update
# ---------------------------------------------------------------------------

def fused_lars_ema_update_buffers(
        p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
        layout: FusedLayout, *, lr: float, tau: float, momentum_decay: float,
        trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
        eps: float = lars_lib.LARS_EPS_DEFAULT,
        ema_pre: bool = False) -> torch.Tensor:
    """K1a then K1b on resident flat buffers, in place on p, m and t.
    Returns the applied trust ratios of the adapted segments in leaf order
    (the ``trust_ratio_vector`` contract), ones(1) if none is adapted."""
    scale, _ = segment_norms(p, g, layout, trust_coefficient, eps)
    fused_apply(p, g, m, t, scale, layout, lr=lr, tau=tau,
                momentum_decay=momentum_decay, ema_pre=ema_pre)
    adapted = [i for i, a in enumerate(layout.seg.adapted) if a]
    if not adapted:
        return torch.ones(1, device=p.device)
    return scale[torch.tensor(adapted, device=p.device)]

