"""Named rematerialization policies (counterpart of byol_tpu/core/remat.py).

The names are JAX's (``--remat-policy``, ``ModelConfig.remat_policy``);
each applies per residual or encoder block through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, one
checkpoint per block, the granularity JAX's ``nn.remat`` of the block
class has:

- ``none``: the block is not wrapped;
- ``full``, ``nothing``: the block's input is its only residual, and its
  backward re-runs the whole block (JAX's save-nothing remat and
  ``nothing_saveable``);
- ``dots``: every conv and matmul output is saved, the elementwise, norm
  and activation chains between them are recomputed (``dots_saveable``):
  selective activation checkpointing (``create_selective_checkpoint_
  contexts``) with ``MUST_SAVE`` on ``aten.convolution``, ``aten.mm``,
  ``aten.addmm``, ``aten.bmm`` and ``aten.baddbmm``;
- ``dots_no_batch``: only the contractions with no batch dims, ``aten.mm``
  and ``aten.addmm``; ``bmm`` and every conv are recomputed (JAX's
  ``dots_with_no_batch_dims_saveable`` saves no conv and no batched dot);
- ``save_block_out``: only the tagged block outputs (:func:`tag_block_out`)
  are kept.  Under a per-block checkpoint a block's output is the next
  block's input, which is the checkpoint's one residual, so this saves
  what ``full`` saves; JAX's policy, whose remat'd block keeps the tagged
  output, leaves the same set;
- ``offload_block_out``: as ``save_block_out``, with those residuals (each
  block's input: the previous block's tagged output, or the embedding
  for the first) packed into pinned host memory by saved-tensor hooks
  around the checkpoint (the hooks see the checkpoint's saved inputs and
  nothing inside it; :func:`offload_stats` counts the bytes) and copied
  back for the recompute.  On a CPU tensor there is nothing to offload.

Which ops the SAC policy sees (:func:`probe_ops`; no autocast, the
layers cast to bf16 themselves): an encoder block's ``Dense`` on a (B, S,
D) input reaches the dispatcher as ``aten.addmm`` on the folded (B*S, D)
matrix (``F.linear`` folds a contiguous 3-D input), ``q @ k^T`` and
``p @ v`` as ``aten.bmm`` (``matmul`` folds B and H), and a ResNet
block's convs as ``aten.convolution``; ``aten.mm`` would come from a 2-D
input without a bias.  Seen so on torch 2.13.0+cpu (fp32, ViT and
ResNet blocks) and on an H100 with torch 2.11.0+cu128 (bf16 ViT-B/16
blocks: ``aten.addmm`` and ``aten.bmm``, printed by ``chip_smoke.py``'s
vit phase).

The trap: a checkpoint re-runs the block's forward during the backward,
so a train-mode BatchNorm would tick its running statistics twice (and,
under ``sync``, all-reduce them again).  Each checkpoint therefore runs
its recompute under :func:`recomputing`, composed with SAC's pair of
contexts: there :class:`~byol_tpu_torch.models.layers.BatchNorm` runs the
same ops on the same batch and leaves its buffers alone, so the
recomputed output equals the first forward's bit for bit and the
statistics move once, as under flax's ``nn.remat``.  Without autograd
(the target network, eval, serving) a block runs plainly: nothing is
saved, so nothing is recomputed.

A names-based policy whose forward carries no tag raises
:class:`RematTagError` (:func:`assert_tags_in_forward`, one dry forward
at build time), as JAX's build does.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# the tag every residual/encoder block output carries (models/resnet.py,
# models/vit.py); names-based policies key on it
BLOCK_OUT = "block_out"

POLICY_NAMES = ("none", "full", "nothing", "dots", "dots_no_batch",
                "save_block_out", "offload_block_out")

# policies that key on the tag: without one they would save nothing
NAMES_BASED_POLICIES = ("save_block_out", "offload_block_out")

_aten = torch.ops.aten
# dots_saveable: every dot_general and conv
_DOTS = frozenset({_aten.convolution.default, _aten.mm.default,
                   _aten.addmm.default, _aten.bmm.default,
                   _aten.baddbmm.default})
# dots_with_no_batch_dims_saveable: no conv, no batched dot
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})
_SAVED_OPS = {"dots": _DOTS, "dots_no_batch": _DOTS_NO_BATCH}


class RematTagError(ValueError):
    """A names-based remat policy matched zero block_out tags."""


_local = threading.local()


def recomputing() -> bool:
    """True while a checkpoint re-runs a block's forward in the backward:
    BatchNorm then leaves its running statistics alone."""
    return getattr(_local, "recompute_depth", 0) > 0


@contextlib.contextmanager
def _recompute_context() -> Iterator[None]:
    _local.recompute_depth = getattr(_local, "recompute_depth", 0) + 1
    try:
        yield
    finally:
        _local.recompute_depth -= 1


def validate_policy(name: str) -> str:
    """Fail fast on typos, with JAX's message."""
    if name not in POLICY_NAMES:
        raise ValueError(
            f"unknown remat policy {name!r}; known: {POLICY_NAMES}")
    return name


def resolve_policy_name(remat: bool, remat_policy: str) -> str:
    """Merge the legacy ``--remat`` bool with the named policy: the bool
    means ``full``, and a named policy wins over it."""
    validate_policy(remat_policy)
    if remat_policy != "none":
        return remat_policy
    return "full" if remat else "none"


def tag_block_out(x: torch.Tensor) -> torch.Tensor:
    """Tag a block output (the identity); counted while
    :func:`assert_tags_in_forward` traces."""
    counter = getattr(_local, "tags", None)
    if counter is not None:
        counter.append(BLOCK_OUT)
    return x


# -- the probe of what the SAC policy sees ---------------------------------
_probe: Optional[List[str]] = None


@contextlib.contextmanager
def probe_ops() -> Iterator[List[str]]:
    """Record the name of every op a selective policy is asked about (in
    the first forward, not the recompute) while the context is open."""
    global _probe
    seen: List[str] = []
    _probe = seen
    try:
        yield seen
    finally:
        _probe = None


def _selective_policy(saved: frozenset) -> Callable[..., CheckpointPolicy]:
    def policy_fn(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if _probe is not None and not ctx.is_recompute:
            _probe.append(str(op))
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy_fn


def _context_fn(policy_name: str):
    """checkpoint's ``context_fn``: (forward context, recompute context),
    SAC's pair under a selective policy, the recompute always under
    :func:`_recompute_context`."""
    saved = _SAVED_OPS.get(policy_name)

    def context_fn():
        if saved is None:
            return contextlib.nullcontext(), _recompute_context()
        fwd, rec = create_selective_checkpoint_contexts(
            _selective_policy(saved))

        @contextlib.contextmanager
        def recompute():
            with _recompute_context(), rec:
                yield
        return fwd, recompute()
    return context_fn


# -- offload of the block inputs to pinned host memory -----------------------
_offload = {"tensors": 0, "bytes": 0}


def offload_stats(reset: bool = False) -> Dict[str, int]:
    """Tensors and bytes ``offload_block_out`` packed into pinned host
    memory since the last reset."""
    out = dict(_offload)
    if reset:
        _offload.update(tensors=0, bytes=0)
    return out


def _pack_to_host(t: torch.Tensor):
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.size(), dtype=t.dtype, layout=t.layout,
                       pin_memory=True)
    host.copy_(t, non_blocking=True)
    _offload["tensors"] += 1
    _offload["bytes"] += t.numel() * t.element_size()
    return t.device, host


def _unpack_from_host(packed):
    if isinstance(packed, torch.Tensor):
        return packed
    device, host = packed
    return host.to(device, non_blocking=True)


def _checkpointed(block: Callable, policy_name: str, x: torch.Tensor
                  ) -> torch.Tensor:
    if not torch.is_grad_enabled():
        return block(x)
    run = functools.partial(checkpoint, block, x, use_reentrant=False,
                            context_fn=_context_fn(policy_name))
    if policy_name == "offload_block_out":
        with torch.autograd.graph.saved_tensors_hooks(_pack_to_host,
                                                      _unpack_from_host):
            return run()
    return run()


def wrap_block(block: Callable[[torch.Tensor], torch.Tensor],
               policy_name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``block`` (a module) under the named policy: ``none`` returns it
    untouched; every other name returns a callable that runs it under one
    checkpoint (when autograd records)."""
    validate_policy(policy_name)
    if policy_name == "none":
        return block
    return functools.partial(_checkpointed, block, policy_name)


def set_remat_policy(net: torch.nn.Module, policy_name: str) -> None:
    """Switch every backbone of ``net`` that takes a policy to
    ``policy_name`` (one built net, several policies)."""
    validate_policy(policy_name)
    for m in net.modules():
        if hasattr(m, "remat_policy"):
            m.remat_policy = policy_name


def assert_tags_in_forward(fn: Callable[..., Any], *args,
                           policy_name: str, **kwargs) -> int:
    """Raise :class:`RematTagError` when a names-based policy finds no
    block_out tag in one dry forward of ``fn`` (run without autograd);
    -> the number of tags seen (0, without running, for the other
    policies)."""
    if policy_name not in NAMES_BASED_POLICIES:
        return 0
    _local.tags = []
    try:
        with torch.no_grad():
            fn(*args, **kwargs)
        tags = _local.tags
    finally:
        _local.tags = None
    if BLOCK_OUT not in tags:
        raise RematTagError(
            f"remat policy {policy_name!r} keys on checkpoint_name tag "
            f"{BLOCK_OUT!r}, but the traced graph carries no such tag "
            f"(found: {sorted(t for t in tags if t) or 'none'}). The "
            "policy would silently save NOTHING — the save-nothing "
            "backward graph is the known XLA compile hazard. A model "
            "block probably lost its tag_block_out call.")
    return len(tags)
