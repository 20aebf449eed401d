"""The CUDA kernels' launchers, their plain PyTorch versions, and the
routing between them by tensor device."""
