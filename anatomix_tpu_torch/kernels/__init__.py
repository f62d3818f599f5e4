"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and a launch counter. Importing this package builds nothing: the
CUDA libraries compile at first launch (`kernels/build.py`)."""
