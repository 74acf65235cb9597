#!/usr/bin/env python
"""Launcher of the PyTorch port: ``python train_torch.py <flags>``, the
counterpart of ``train.py``, with the JAX CLI's flags
(byol_tpu_torch/cli.py).

One process per card: ``torchrun --nproc_per_node N train_torch.py ...``
on one node (``launch/h100_node_run.sh`` across SLURM nodes), or one
process with ``--no-cuda`` on the CPU."""
from byol_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
