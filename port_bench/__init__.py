"""The port's benchmark: box-scale training cells of the PyTorch and CUDA
port on one H100, driven by the data files under this directory."""
