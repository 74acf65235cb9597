"""The plan of how a run lays its state over the data axis (counterpart
of byol_tpu/parallel/compile_plan.py).

JAX's plan owns every jit entry point's shardings and donations.  The
port has no compiler to instruct: its state is resident and flat, and the
train step updates it in place (what JAX's donation of the state buys).
The plan keeps what is left: the data axis's size (``world``: the ranks
ZeRO-1 shards over; a sequence group's ranks hold one range each), the
sequence and model axes' (the model axis's heads are split by
models/byol_net.py::shard_heads before the state is made), ``--zero1``,
``--flat-resident`` and ``--flat-bucket-mb``; it shards a train state
(:meth:`CompilePlan.prepare`), names itself in the run header
(:meth:`CompilePlan.describe`, JAX's fields) and converts at the
checkpoint boundary (:meth:`to_canonical` / :meth:`from_canonical`), so a
checkpoint never depends on the layout.  The CUDA-graph capture of the
step waits (ROADMAP.md, section 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

from byol_tpu_torch.parallel import collectives
from byol_tpu_torch.parallel.flat_state import DEFAULT_BUCKET_MB
from byol_tpu_torch.parallel.mesh import (AXIS_NAMES, DATA_AXIS, MODEL_AXIS,
                                          SEQUENCE_AXIS, process_info)
from byol_tpu_torch.parallel.zero1 import Zero1Context
from byol_tpu_torch.training.state import opt_fields

# JAX's per-entry-point donations, kept for the run header: the port's
# train step writes the state's buffers in place, and the serving engine
# stages each batch into a buffer of its own
DONATE = {
    "train_step": (0,),
    "eval_step": (),
    "encoder_extractor": (),
    "spmd_extractor": (),
    "serve_step": (0,),
}


@dataclasses.dataclass(frozen=True)
class CompilePlan:
    world: int = 1                  # the data axis
    zero1: bool = False
    flat_resident: bool = False
    bucket_mb: int = DEFAULT_BUCKET_MB
    sequence: int = 1
    model: int = 1

    @property
    def pad_rows_to(self) -> int:
        """The train state's buffers hold a multiple of this many rows."""
        return self.world if self.zero1 else 1

    def prepare(self, state, *, weight_decay: float) -> None:
        """Make ``state`` (fresh from ``create_train_state(pad_rows_to=
        self.pad_rows_to)``) this plan's: rank 0's params, target, Polyak
        average and BatchNorm statistics on every rank, and under ZeRO-1
        the rank's range context with the optimizer's state cut to its
        shard.  The broadcast runs over the data axis: each model index
        keeps its own shards of the heads."""
        if collectives.is_initialized():
            # every rank draws the same weights from the seed; the
            # broadcast makes the replicas' start equal by construction
            with torch.no_grad():
                for buf in [state.params, state.target] + (
                        [state.polyak] if state.polyak is not None else []) \
                        + list(state.batch_stats().values()):
                    collectives.broadcast_(buf, 0)
        if not self.zero1:
            return
        if self.model > 1:
            from byol_tpu_torch.core.config import ZERO1_MODEL_PARALLEL
            raise ValueError(ZERO1_MODEL_PARALLEL)
        ctx = Zero1Context.build(
            state.seg, world=self.world, rank=process_info()[0],
            weight_decay=weight_decay, device=state.params.device,
            bucket_mb=self.bucket_mb if self.flat_resident else None)
        if state.params.numel() != ctx.total_elements:
            raise ValueError(
                f"ZeRO-1 over {self.world} ranks needs buffers of "
                f"{ctx.total_elements} elements; the state has "
                f"{state.params.numel()} (create_train_state(pad_rows_to="
                f"{self.world}))")
        # every buffer of the optimizer's state but lbfgs's one vector
        # lives on the rank's range only
        kinds = opt_fields(state.optimizer)
        state.opt = {name: (buf if kinds[name] == "vector"
                            else ctx.shard_of(buf).clone())
                     for name, buf in state.opt.items()}
        state.zero1 = ctx

    def describe(self) -> Dict[str, Any]:
        """The run header's ``sharding_plan``, with JAX's fields."""
        return {
            "mesh_shape": {DATA_AXIS: int(self.world),
                           SEQUENCE_AXIS: int(self.sequence),
                           MODEL_AXIS: int(self.model)},
            "axis_names": list(AXIS_NAMES),
            "zero1": "on" if self.zero1 else "off",
            "donate_argnums": {k: list(v) for k, v in DONATE.items()},
            "flat_resident": "on" if self.flat_resident else "off",
            "flat_bucket_mb": int(self.bucket_mb),
        }

    # -- checkpoint codec ------------------------------------------------
    def to_canonical(self, state) -> Dict[str, Any]:
        """The layout-free host tree of ``state``, the optimizer's state
        gathered whole (a collective under ZeRO-1: every rank calls
        it)."""
        from byol_tpu_torch.training.state import canonical_state
        return canonical_state(state)

    def from_canonical(self, state, tree: Mapping[str, Any]) -> None:
        """Load a layout-free tree into ``state``, in place; under ZeRO-1
        each rank keeps its range of the optimizer's state."""
        from byol_tpu_torch.training.state import load_canonical
        load_canonical(state, tree)


def build_plan(world: int = 1, *, zero1: bool = False,
               flat_resident: bool = False,
               bucket_mb: int = DEFAULT_BUCKET_MB,
               sequence: int = 1, model: int = 1) -> CompilePlan:
    """The one constructor: ``cfg.device.zero1 == 'on'`` -> a ZeRO-1
    plan, ``flat_resident`` -> bucketed gathers."""
    if bucket_mb < 1:
        raise ValueError(f"flat_bucket_mb must be >= 1, got {bucket_mb}")
    return CompilePlan(world=world, zero1=zero1, flat_resident=flat_resident,
                       bucket_mb=bucket_mb, sequence=sequence, model=model)


def plan_from_cfg(cfg, world: int) -> CompilePlan:
    """The plan of ``cfg`` over a data axis of ``world`` ranks."""
    return build_plan(world, zero1=cfg.device.zero1 == "on",
                      flat_resident=cfg.device.flat_resident == "on",
                      bucket_mb=cfg.device.flat_bucket_mb,
                      sequence=cfg.device.sequence_parallel,
                      model=cfg.device.model_parallel)
