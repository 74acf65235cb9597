"""The mesh over torch.distributed (counterpart of
byol_tpu/parallel/mesh.py).

One process per card.  The world is laid out as JAX reshapes its devices
into the ``(data, sequence, model)`` mesh: rank = (d S + s) M + m, for data
index d < D, sequence index s < S and model index m < M
(:func:`init_mesh`).  The data group (the ranks that share s and m) holds
the rows of the global batch, data rank d its rows ``[d L, (d + 1) L)``,
``L = global / D``, the process-major order of JAX's
``shard_batch_to_mesh``; the ranks of one sequence group (the ranks that
share d and m) hold the same rows, and ring attention
(parallel/ring_attention.py) runs across them; the ranks of one model
group (the ranks that share d and s) hold the same rows too, and the
tensor-parallel heads (parallel/partitioning.py) split their hidden dim
across them.  :func:`process_info` is the data axis's ``(d, D)``.  With
neither axis (S = M = 1, the default) the data group is the whole world
and every helper does what it did before those axes existed.
``--dcn-data-parallel`` > 1 has no meaning here, since NCCL builds its own
rings over NVLink and IB.

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
SEQUENCE_AXIS = "sequence"
MODEL_AXIS = "model"
# the JAX mesh's axes
AXIS_NAMES = (DATA_AXIS, SEQUENCE_AXIS, MODEL_AXIS)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a gloo group beside an NCCL one, for the host's small control messages
# (lockstep statuses, the preemption flag): they then wait on no stream
_control_group = None


@dataclasses.dataclass(frozen=True)
class _Axis:
    size: int
    index: int
    ranks: Tuple[int, ...]    # the global ranks of this rank's group
    group: Any                # None: the default group (or no group)


# init_mesh's layout; None: the data axis is the world
_layout: Optional[Dict[str, _Axis]] = None


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
    """``(d, D)``: the data axis's index and size, what JAX's
    ``(process_index, process_count)`` is to the loader and the split of
    the batch (the whole world's ``(rank, world)`` without a sequence
    axis)."""
    return axis_index(DATA_AXIS), axis_size(DATA_AXIS)


def is_primary() -> bool:
    """Rank 0 alone logs, graphs and writes checkpoints."""
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def shutdown() -> None:
    global _control_group, _layout
    if is_initialized():
        dist.destroy_process_group()
    _control_group = None
    _layout = None


def init_mesh(sequence: int = 1, model: int = 1) -> Dict[str, int]:
    """Lay the world out as ``(data, sequence, model)``, rank = (d S + s)
    M + m, and build the groups of the axes that exist: every rank calls
    it with the same sizes, and the groups are made in one order on every
    rank (the data groups, then the sequence groups, then the model
    groups).  -> the mesh shape.  ``sequence`` = ``model`` = 1 keeps the
    data axis the whole world and builds no group."""
    global _layout
    world, r = world_size(), rank()
    tp_sp = sequence * model
    if tp_sp < 1 or tp_sp > world or world % tp_sp:
        raise ValueError(
            f"model_parallel x sequence_parallel = {tp_sp} does not "
            f"divide the {world} available devices")
    n_data = world // tp_sp
    if mesh_shape() == {DATA_AXIS: n_data, SEQUENCE_AXIS: sequence,
                        MODEL_AXIS: model}:
        return mesh_shape()                  # laid out already
    if tp_sp == 1:
        _layout = None
        return mesh_shape()
    sizes = {DATA_AXIS: n_data, SEQUENCE_AXIS: sequence, MODEL_AXIS: model}
    here = {DATA_AXIS: r // tp_sp, SEQUENCE_AXIS: r // model % sequence,
            MODEL_AXIS: r % model}

    def rank_at(at):
        return (at[DATA_AXIS] * sequence + at[SEQUENCE_AXIS]) * model \
            + at[MODEL_AXIS]
    layout = {}
    for axis in AXIS_NAMES:
        if axis != DATA_AXIS and sizes[axis] == 1:
            layout[axis] = _Axis(1, 0, (r,), None)
            continue
        others = [a for a in AXIS_NAMES if a != axis]
        # one group per value of the other two axes, in their order
        for i in range(sizes[others[0]]):
            for j in range(sizes[others[1]]):
                at = {others[0]: i, others[1]: j}
                ranks = tuple(rank_at(dict(at, **{axis: k}))
                              for k in range(sizes[axis]))
                group = dist.new_group(list(ranks))
                if r in ranks:
                    layout[axis] = _Axis(sizes[axis], here[axis], ranks,
                                         group)
    _layout = layout
    return mesh_shape()


def _axis(name: str) -> _Axis:
    if name not in AXIS_NAMES:
        raise ValueError(f"unknown mesh axis {name!r}; known: {AXIS_NAMES}")
    if _layout is not None:
        return _layout[name]
    if name == DATA_AXIS:
        return _Axis(world_size(), rank(), tuple(range(world_size())), None)
    return _Axis(1, 0, (rank(),), None)


def axis_size(name: str) -> int:
    """The size of a mesh axis (1 without a group)."""
    return _axis(name).size


def axis_index(name: str) -> int:
    """This rank's index along a mesh axis."""
    return _axis(name).index


def axis_group(name: str):
    """The process group of this rank's slice along ``name`` (None: the
    default group)."""
    return _axis(name).group


def axis_ranks(name: str) -> Tuple[int, ...]:
    """The global ranks of this rank's group along ``name``, in axis
    order."""
    return _axis(name).ranks


def mesh_shape() -> Dict[str, int]:
    """``{data, sequence, model}`` sizes of the laid-out world."""
    return {a: axis_size(a) for a in AXIS_NAMES}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The data axis: ``data`` processes (-1: what the laid-out mesh's
    sequence and model axes leave of the world)."""

    data: int = -1

    def resolved(self) -> int:
        n_data = axis_size(DATA_AXIS)
        if self.data not in (-1, n_data):
            raise ValueError(f"mesh data axis {self.data} != world size "
                             f"{world_size()} over sequence x model "
                             f"{world_size() // n_data}")
        return n_data

    @property
    def shape(self) -> Dict[str, int]:
        return dict(mesh_shape(), **{DATA_AXIS: self.resolved()})


def local_rows(global_batch: int) -> int:
    """Rows of a global batch on each data rank."""
    n_data = axis_size(DATA_AXIS)
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"data axis {n_data}")
    return global_batch // n_data


def shard_batch(batch: Mapping[str, Any],
                index: Optional[int] = None,
                count: Optional[int] = None) -> Dict[str, Any]:
    """This data rank's rows ``[d L, (d + 1) L)`` of a global batch."""
    d, n_data = process_info()
    index = d if index is None else index
    count = n_data if count is None else count
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
