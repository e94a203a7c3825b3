"""Edge and segment operations: plain PyTorch versions and the wrappers of
the hand-written CUDA kernels (``csrc/``)."""
