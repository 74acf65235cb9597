"""PyTorch/CUDA port of byol_tpu for NVIDIA Hopper (see README.md)."""
