"""Run metadata and parameter counting (counterpart of
byol_tpu/utils/__init__.py, the reference's ``helpers.utils``).

- :func:`get_slurm_id`: the SLURM job (and array task) id, JAX's copy;
- :func:`get_aws_instance_id`: the EC2 instance id, or None off EC2.  JAX
  asks the metadata endpoint on every machine, with a 0.25 s timeout; the
  port asks it only on a machine whose firmware tables name Amazon EC2 as
  the vendor (``/sys/devices/virtual/dmi/id``), and there reads the id
  from the board's asset tag first, which Nitro instances set to it, so a
  machine off EC2 opens no connection at all;
- :func:`get_gpu_env`: the card counterpart of JAX's ``get_tpu_env``:
  ``CUDA_VISIBLE_DEVICES``, torchrun's ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE`` where they are set, and the name of the card this
  process drives;
- :func:`number_of_parameters`: the elements of every leaf of a tree
  (unpadded: the flat buffers' padding is not a parameter).
"""
from __future__ import annotations

import math
import os
from collections.abc import Mapping
from typing import Any, Optional

_DMI = "/sys/devices/virtual/dmi/id"
_METADATA = "http://169.254.169.254/latest/meta-data/instance-id"


def get_slurm_id() -> Optional[str]:
    """SLURM job identity for run metadata (main.py:775-777)."""
    job = os.environ.get("SLURM_JOB_ID")
    task = os.environ.get("SLURM_ARRAY_TASK_ID")
    if job and task:
        return f"{job}_{task}"
    return job


def _dmi(field: str) -> str:
    try:
        with open(os.path.join(_DMI, field)) as f:
            return f.read().strip()
    except OSError:
        return ""


def _on_ec2() -> bool:
    """The firmware names Amazon EC2 as the machine's vendor."""
    return any(_dmi(f).startswith("Amazon EC2")
               for f in ("sys_vendor", "board_vendor"))


def get_aws_instance_id(timeout: float = 0.25) -> Optional[str]:
    """EC2 instance id (main.py:128-130); None quickly off EC2."""
    if not _on_ec2():
        return None
    tag = _dmi("board_asset_tag")
    if tag.startswith("i-"):
        return tag
    import urllib.request
    try:
        with urllib.request.urlopen(_METADATA,  # noqa: S310
                                    timeout=timeout) as r:
            return r.read().decode()
    except Exception:  # noqa: BLE001 - metadata is optional, like JAX's
        return None


def get_gpu_env() -> dict:
    """The card's run metadata (JAX's ``get_tpu_env`` for a TPU pod)."""
    keys = ("CUDA_VISIBLE_DEVICES", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    env = {k: os.environ[k] for k in keys if k in os.environ}
    import torch
    if torch.cuda.is_available():
        env["device_name"] = torch.cuda.get_device_name(
            torch.cuda.current_device())
    return env


def number_of_parameters(params: Any) -> int:
    """Total elements of a tree's leaves (main.py:447-449): nested
    mappings, lists and tuples of arrays or tensors."""
    if hasattr(params, "shape"):
        return math.prod(int(d) for d in params.shape)
    if isinstance(params, Mapping):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(number_of_parameters(p) for p in params)
    return 0
