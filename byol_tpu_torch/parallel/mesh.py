"""The data axis over torch.distributed (counterpart of
byol_tpu/parallel/mesh.py).

One process per card: rank r drives ``cuda:LOCAL_RANK`` and holds rows
``[r L, (r + 1) L)`` of every global batch, ``L = global / world``, the
process-major order of JAX's ``shard_batch_to_mesh``.  The mesh has the
data axis only; ``--model-parallel`` and ``--sequence-parallel`` > 1 are
refused (ROADMAP.md, section 1 item 14), and ``--dcn-data-parallel`` > 1
has no meaning here, since NCCL builds its own rings over NVLink and IB.

:func:`initialize_distributed` joins the process group: from the
environment ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), from the JAX CLI's flags
(``--distributed-master``, ``--distributed-rank``, ``--num-processes``,
``--distributed-port``), or from a store a test hands over.  NCCL for a
card, gloo for the CPU, which only ``--no-cuda`` or a test asks for.  A
failed rendezvous raises.  Without any of them there is no process group
and the world is 1: the one-card paths run exactly as they did.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
# the JAX mesh's axes; the port's sequence and model axes are size 1
AXIS_NAMES = (DATA_AXIS, "sequence", "model")

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a gloo group beside an NCCL one, for the host's small control messages
# (lockstep statuses, the preemption flag): they then wait on no stream
_control_group = None


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _TORCHRUN_ENV)


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(no_cuda: bool = False) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK``, made current, or the
    CPU under ``no_cuda``.  A missing card raises."""
    if no_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --no-cuda (device='cpu') to run "
            "on the CPU")
    index = local_rank()
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {index} names a card this process does not see "
            f"({torch.cuda.device_count()} visible)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize_distributed(device, *, master: str = "", rank: int = 0,
                           world_size: int = 0, port: int = 29300,
                           store: Optional[Any] = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the data axis's process group, once; True when this process
    is in one.  ``device`` picks the backend: NCCL (``device_id`` set) for
    a card, gloo for the CPU.  Sources, first match wins: a group that
    exists; ``store`` with ``rank``/``world_size`` (tests: a FileStore);
    the torchrun environment; ``master`` (``host`` or ``host:port``) with
    ``rank`` and ``world_size`` (the JAX CLI's ``--distributed-*`` and
    ``--num-processes``).  None of them: no group, world 1."""
    if dist.is_initialized():
        return True
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw: Dict[str, Any] = dict(
        backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        # NCCL binds the group to one card, named with its index
        kw["device_id"] = (device if device.index is not None else
                           torch.device("cuda", torch.cuda.current_device()))
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world_size)
    elif launched_by_torchrun():
        kw.update(init_method="env://")
    elif master:
        if world_size < 1:
            raise ValueError("--distributed-master needs --num-processes "
                             "(the world size) >= 1")
        host, _, port_s = master.partition(":")
        kw.update(init_method=f"tcp://{host}:{port_s or port}", rank=rank,
                  world_size=world_size)
    else:
        return False
    global _control_group
    dist.init_process_group(**kw)
    _control_group = (dist.new_group(backend="gloo") if backend == "nccl"
                      else None)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_info() -> Tuple[int, int]:
    """``(rank, world)``, JAX's ``(process_index, process_count)``."""
    return rank(), world_size()


def is_primary() -> bool:
    """Rank 0 alone logs, graphs and writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    global _control_group
    if is_initialized():
        dist.destroy_process_group()
    _control_group = None


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The data axis: ``data`` processes (-1: the whole world)."""

    data: int = -1

    def resolved(self) -> int:
        world = world_size()
        if self.data not in (-1, world):
            raise ValueError(f"mesh data axis {self.data} != world size "
                             f"{world}")
        return world

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.resolved(), "sequence": 1, "model": 1}


def local_rows(global_batch: int) -> int:
    """Rows of a global batch on each rank."""
    world = world_size()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"world size {world}")
    return global_batch // world


def shard_batch(batch: Mapping[str, Any],
                index: Optional[int] = None,
                count: Optional[int] = None) -> Dict[str, Any]:
    """This rank's rows ``[r L, (r + 1) L)`` of a global batch."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    n = len(next(iter(batch.values())))
    if n % count:
        raise ValueError(f"global batch {n} not divisible by {count} ranks")
    per = n // count
    return {k: v[index * per:(index + 1) * per] for k, v in batch.items()}


def control_group():
    """The group of the host's small control messages: gloo beside NCCL,
    or None for the default group."""
    return _control_group


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``src``'s picklable ``obj`` on every rank."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=_control_group)
    return box[0]
