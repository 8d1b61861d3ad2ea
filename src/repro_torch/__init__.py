"""repro_torch: the FFTMatvec operator (block-triangular Toeplitz matvec in
mixed precision, SC-W '25) on PyTorch and hand-written CUDA kernels for
NVIDIA Hopper.  A port of the JAX package ``repro``; it imports nothing
from it."""

__version__ = "0.1.0"
