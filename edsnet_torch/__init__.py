"""PyTorch/CUDA port of edsnet_tpu for NVIDIA Hopper GPUs."""
