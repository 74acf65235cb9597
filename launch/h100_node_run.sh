#!/usr/bin/env bash
# SLURM launch of the PyTorch port on H100 nodes: one torchrun per node,
# eight processes per node (one per card, rank r on cuda:LOCAL_RANK),
# rendezvous on the allocation's first node, NCCL over NVLink within a
# node and the cluster's network between nodes.
#
#   sbatch launch/h100_node_run.sh                     # the defaults below
#   ARGS="... --model-parallel 2" sbatch launch/h100_node_run.sh
#
# --model-parallel M splits the projector/predictor heads over groups of
# M neighbouring ranks (one node's cards for M <= 8) and needs the unfused
# update (--fused-update off, --zero1 off, --fused-augment off); the data
# axis is then nodes x 8 / M ranks.
#
#SBATCH --job-name=byol_tpu_torch
#SBATCH --nodes=2
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node=8
#SBATCH --cpus-per-task=64
#SBATCH --time=72:00:00
#SBATCH --output=byol_tpu_torch_%j_%t.log
set -euo pipefail

# The reference's scale: global batch 1024, 100 epochs of ImageNet.
ARGS=${ARGS:-"--task image_folder --data-dir $HOME/datasets/imagenet \
  --batch-size 1024 --epochs 100 --arch resnet50 --half \
  --fused-update on --augment-placement step --fused-augment on \
  --uid slurm_${SLURM_JOB_ID:-0}"}
PORT=${PORT:-29300}
GPUS=${GPUS:-8}

MASTER=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)

srun --kill-on-bad-exit=1 bash -c "
torchrun --nnodes \$SLURM_NNODES --nproc_per_node ${GPUS} \
  --node_rank \$SLURM_NODEID --master_addr ${MASTER} \
  --master_port ${PORT} \
  train_torch.py $ARGS --model-dir \$HOME/models
"
