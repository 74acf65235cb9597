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
  segment row starts, weight decay and exclusion per segment), built once,
  over the whole buffer or over one rank's range of rows (ZeRO-1).
- :func:`segment_norms` (K1a): per-segment ``|p|`` and ``|g + wd p|`` and
  the applied trust scale; deterministic (no atomics).
- :func:`fused_apply` (K1b): wd fold-in, trust scale, momentum tick, param
  write and EMA tick, in place on p, m and t.
- :func:`fused_lars_ema_update_buffers` runs both on the flat buffers (the
  counterpart of ``_fused_update_buffers``).
- K1a split: :func:`segment_sums` (the range's float64 per-segment
  sums, stopped before the square root) and :func:`segment_epilogue`
  (global sums -> norms, trust scale);
  :func:`fused_lars_ema_update_zero1` all-reduces the sums between them
  and runs K1b on the range (ZeRO-1's fused update), and every LARS and
  LAMB chain of the optimizer registry takes its per-leaf norms from the
  pair (optim/transforms.py), on the whole buffer or a range.

Each wrapper runs its plain version (``*_reference``) for CPU tensors,
launches its kernel for CUDA tensors, and raises otherwise: nothing falls
back.  ``SEGMENT_NORMS_LAUNCHES`` / ``FUSED_APPLY_LAUNCHES`` /
``SEGMENT_SUMS_LAUNCHES`` / ``SEGMENT_EPILOGUE_LAUNCHES`` count kernel
launches, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from byol_tpu_torch.ops import common
from byol_tpu_torch.optim import lars as lars_lib

LANES = 128

# kernel launches since the count was last set to 0 (only the wrappers'
# launches add to them)
SEGMENT_NORMS_LAUNCHES = 0
FUSED_APPLY_LAUNCHES = 0
SEGMENT_SUMS_LAUNCHES = 0          # K1a split, first half
SEGMENT_EPILOGUE_LAUNCHES = 0      # K1a split, second half


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
    # fp32, or float64 for float64 leaves (the plain versions' tests)
    dtype = functools.reduce(torch.promote_types,
                             [leaf.dtype for leaf in leaves], torch.float32)
    buf = torch.zeros(seg.total, dtype=dtype, device=leaves[0].device)
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
    """The segment map and the weight decay as device tensors, over the
    rows ``[row_lo, row_lo + rows)`` of the flat buffer: all of it, or one
    rank's range under ZeRO-1 (:meth:`build` with ``row_hi``).  A range
    clips the segments it cuts; each clipped segment keeps its global id,
    its adapted flag and its weight decay, so the kernels index the
    per-segment tensors by global id whatever the range."""

    seg: SegmentMap
    row_lo: int
    rows: int
    row_seg: torch.Tensor          # (rows,) int32: global segment per row
    seg_row_start: torch.Tensor    # (nloc + 1,) int32, range-relative
    seg_ids: torch.Tensor          # (nloc,) int32: global ids, in order
    seg_adapted: torch.Tensor      # (nseg,) int32
    seg_wd: torch.Tensor           # (nseg,) fp32: wd on adapted, else 0
    adapted_idx: torch.Tensor      # (n adapted,) int64: the adapted ids

    @property
    def total(self) -> int:
        """Elements of the range."""
        return self.rows * LANES

    @property
    def num_local(self) -> int:
        """Segments the range holds rows of."""
        return self.seg_ids.numel()

    @classmethod
    def build(cls, seg: SegmentMap, weight_decay: float, device,
              row_lo: int = 0, row_hi: Optional[int] = None
              ) -> "FusedLayout":
        row_hi = seg.num_rows if row_hi is None else row_hi
        if not 0 <= row_lo <= row_hi <= seg.num_rows:
            raise ValueError(f"row range [{row_lo}, {row_hi}) outside the "
                             f"buffer's {seg.num_rows} rows")
        adapted = np.asarray(seg.adapted, bool)
        starts = np.asarray(seg.starts + (seg.total,), np.int64) // LANES
        ids = np.nonzero((starts[1:] > row_lo) & (starts[:-1] < row_hi))[0]
        local = np.clip(np.append(starts[ids], row_hi), row_lo,
                        row_hi) - row_lo
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(seg=seg, row_lo=row_lo, rows=row_hi - row_lo,
                   row_seg=to(seg.row_segment_ids()[row_lo:row_hi]),
                   seg_row_start=to(local.astype(np.int32)),
                   seg_ids=to(ids.astype(np.int32)),
                   seg_adapted=to(adapted.astype(np.int32)),
                   seg_wd=to(np.where(adapted, np.float32(weight_decay),
                                      np.float32(0.0)).astype(np.float32)),
                   adapted_idx=to(np.nonzero(adapted)[0].astype(np.int64)))

    def trust_vector(self, scale: torch.Tensor) -> torch.Tensor:
        """The applied trust ratios of the adapted segments in leaf order
        (the ``trust_ratio_vector`` contract), ones(1) if none is
        adapted."""
        if not self.adapted_idx.numel():
            return torch.ones(1, device=scale.device)
        return scale[self.adapted_idx]


def _check(layout: FusedLayout, *bufs: torch.Tensor,
           cpu_float64: bool = False) -> None:
    """Contiguous fp32 buffers of the range on the layout's device;
    ``cpu_float64``: CPU tensors (the plain version) may be float64."""
    dev = bufs[0].device
    dtypes = ((torch.float32, torch.float64)
              if cpu_float64 and dev.type == "cpu" else (torch.float32,))
    for b in bufs:
        if (b.dtype not in dtypes or b.numel() != layout.total
                or not b.is_contiguous() or b.device != dev):
            raise ValueError(
                f"fused update: buffers must be contiguous fp32 with "
                f"{layout.total} elements on one device; got "
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
    return segment_epilogue_reference(segment_sums_reference(p, g, layout),
                                      layout, trust_coefficient, eps)


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
    if layout.rows != layout.seg.num_rows:
        raise ValueError("segment_norms takes the whole buffer; a range's "
                         "norms need the other ranks' sums "
                         "(fused_lars_ema_update_zero1)")
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
# K1a split: range sums -> (all-reduce) -> epilogue
# ---------------------------------------------------------------------------

def segment_sums_reference(p: torch.Tensor, g: torch.Tensor,
                           layout: FusedLayout) -> torch.Tensor:
    """Plain version of the split K1a's first half: fp32 row partials of
    the range, summed per segment in float64, (nseg, 2) by global id."""
    rows = layout.row_seg.long()
    pr, gr = p.view(-1, LANES), g.view(-1, LANES)
    gp = gr + layout.seg_wd[rows][:, None] * pr
    partial = torch.stack([(pr * pr).sum(dim=1), (gp * gp).sum(dim=1)], 1)
    return torch.zeros(layout.seg.num_segments, 2, dtype=torch.float64,
                       device=p.device).index_add_(0, rows, partial.double())


def segment_epilogue_reference(
        sums: torch.Tensor, layout: FusedLayout,
        trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
        eps: float = lars_lib.LARS_EPS_DEFAULT
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the split K1a's second half: (scale, norms) from
    the (nseg, 2) float64 sums."""
    norms = sums.sqrt().float()
    ratio = lars_lib.trust_ratio_from_norms(norms[:, 0], norms[:, 1],
                                            trust_coefficient, eps)
    scale = torch.where(layout.seg_adapted.bool(), ratio,
                        torch.ones_like(ratio))
    return scale, norms


def segment_sums(p: torch.Tensor, g: torch.Tensor,
                 layout: FusedLayout) -> torch.Tensor:
    """K1a split, first half: ``(nseg, 2)`` float64 (sum p^2, sum (g + wd
    p)^2) of the range's rows per segment, zeros on segments outside the
    range.  ``p`` and ``g`` are the range's elements."""
    global SEGMENT_SUMS_LAUNCHES
    # float64 buffers (a float64 net's) are summed by the plain version
    _check(layout, p, g, cpu_float64=True)
    if p.device.type == "cpu":
        return segment_sums_reference(p, g, layout)
    if p.device.type != "cuda":
        raise ValueError(f"segment_sums: no kernel for device {p.device}")
    nseg = layout.seg.num_segments
    sums = torch.empty((nseg, 2), dtype=torch.float64, device=p.device)
    partial = torch.empty((max(layout.rows, 1), 2), dtype=torch.float32,
                          device=p.device)
    fn = common.entry("byol_segment_sums", [_P] * 8 + [_I, _I, _I, _P])
    err = fn(p.data_ptr(), g.data_ptr(), layout.row_seg.data_ptr(),
             layout.seg_wd.data_ptr(), layout.seg_row_start.data_ptr(),
             layout.seg_ids.data_ptr(), partial.data_ptr(), sums.data_ptr(),
             layout.rows, layout.num_local, nseg,
             torch.cuda.current_stream(p.device).cuda_stream)
    common.check(err, "segment_sums")
    SEGMENT_SUMS_LAUNCHES += 1
    return sums


def segment_epilogue(sums: torch.Tensor, layout: FusedLayout,
                     trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
                     eps: float = lars_lib.LARS_EPS_DEFAULT
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1a split, second half: ``(scale (nseg,), norms (nseg, 2))`` from
    the whole buffer's float64 sums, as :func:`segment_norms` returns
    them."""
    global SEGMENT_EPILOGUE_LAUNCHES
    nseg = layout.seg.num_segments
    if (sums.shape != (nseg, 2) or sums.dtype != torch.float64
            or not sums.is_contiguous()
            or sums.device != layout.seg_adapted.device):
        raise ValueError(f"segment_epilogue: sums must be contiguous "
                         f"float64 ({nseg}, 2) on "
                         f"{layout.seg_adapted.device}; got {sums.dtype} "
                         f"{tuple(sums.shape)} on {sums.device}")
    if sums.device.type == "cpu":
        return segment_epilogue_reference(sums, layout, trust_coefficient,
                                          eps)
    if sums.device.type != "cuda":
        raise ValueError(f"segment_epilogue: no kernel for device "
                         f"{sums.device}")
    norms = torch.empty((nseg, 2), dtype=torch.float32, device=sums.device)
    scale = torch.empty(nseg, dtype=torch.float32, device=sums.device)
    fn = common.entry("byol_segment_epilogue", [_P] * 4 + [_I, _F, _F, _P])
    err = fn(sums.data_ptr(), layout.seg_adapted.data_ptr(),
             norms.data_ptr(), scale.data_ptr(), nseg, trust_coefficient,
             eps, torch.cuda.current_stream(sums.device).cuda_stream)
    common.check(err, "segment_epilogue")
    SEGMENT_EPILOGUE_LAUNCHES += 1
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
    if layout.rows == 0:            # a rank whose range is all padding
        return None
    fn = common.entry("byol_fused_apply", [_P] * 7 + [_I, _F, _F, _F, _I, _P])
    err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), t.data_ptr(),
             layout.row_seg.data_ptr(), layout.seg_wd.data_ptr(),
             scale.data_ptr(), layout.rows, lr, tau,
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
    return layout.trust_vector(scale)


def fused_lars_ema_update_zero1(
        p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, t: torch.Tensor,
        layout: FusedLayout, *, lr: float, tau: float, momentum_decay: float,
        trust_coefficient: float = lars_lib.TRUST_COEFFICIENT_DEFAULT,
        eps: float = lars_lib.LARS_EPS_DEFAULT, ema_pre: bool = False,
        all_reduce: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
) -> torch.Tensor:
    """The ZeRO-1 update of one rank's range (counterpart of JAX's
    ``fused_lars_ema_update_zero1``, byol_tpu/ops/fused_update.py:417):
    the split K1a's sums over the range, ``all_reduce`` (an in-place sum
    over the data axis) of the (nseg, 2) float64 sums, its epilogue, then
    K1b on the range, in place on ``p``, ``m`` and ``t``, which hold the
    range's elements (``layout.total``).  The trust ratio depends only on
    the global per-segment sums and the rest is elementwise, so each rank's
    range gets what the whole-buffer update writes there.  Returns the
    trust vector as :func:`fused_lars_ema_update_buffers` does."""
    sums = all_reduce(segment_sums(p, g, layout))
    scale, _ = segment_epilogue(sums, layout, trust_coefficient, eps)
    fused_apply(p, g, m, t, scale, layout, lr=lr, tau=tau,
                momentum_decay=momentum_decay, ema_pre=ema_pre)
    return layout.trust_vector(scale)

