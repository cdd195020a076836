"""PyTorch/CUDA port of slowfast_tpu for NVIDIA Hopper (H100)."""
