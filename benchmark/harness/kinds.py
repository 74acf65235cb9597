"""Sorts the device's kernel names into kinds.

A frozen copy of ``_kind`` in ``chip_smoke.py`` (the repository's smoke
script, as of the port's slice 15), so that a later change to that script
cannot change how the benchmark reads a trace.  ``K3``, ``K1a``, ``K1b``
and ``K2`` are the port's hand-written kernels (flash attention, the
fused update's norms and its apply, the two-view augmentation).
"""
from __future__ import annotations


def kind(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "two_view_" in name and "_kernel" in name:
        return "K2_two_view"
    if "row_norms_kernel" in name or "segment_reduce_kernel" in name:
        return "K1a_segment_norms"
    if "segment_sums_kernel" in name or "segment_epilogue_kernel" in name:
        return "K1a_split"
    if "nccl" in name:
        return "nccl"
    if "fused_apply_kernel" in name:
        return "K1b_fused_apply"
    if "memcpy" in name or "memset" in name:
        return "memcpy"
    if "batch_norm" in name or "batchnorm" in name or "bn_" in name:
        return "batch_norm"
    if any(w in name for w in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    for op in ("layer_norm", "gelu", "copy", "cat", "add"):
        if op in name:
            return op
    if "elementwise" in name or "reduce" in name:
        return "elementwise"
    return "other"
