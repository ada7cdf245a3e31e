"""The benchmark of the PyTorch and CUDA port (lizard_tpu_torch) on one
NVIDIA H100: see README.md."""
