"""Hand-written CUDA kernels for the paper's compute hot spot (short-wide
SBGEMV) and the fused pad/cast memory ops, with backend-dispatching
wrappers (``ops.py``) and oracles (``ref.py``).  Kernels build at first
use on the card (``_build.py``); nothing is compiled at import."""

from . import ops, ref  # noqa: F401
