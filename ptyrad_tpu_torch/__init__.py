"""ptyrad_tpu_torch: the PyTorch/CUDA port of ptyrad_tpu.

Differentiable mixed-state multislice ptychography on an NVIDIA H100: plain
tensor code is PyTorch (native complex64, ``torch.fft``), and the kernels the
JAX package wrote in Pallas for the TPU are CUDA C++ kernels written by hand
for Hopper (``csrc/``), compiled with ``nvcc`` at first CUDA use.

Module names follow ``ptyrad_tpu`` so each counterpart is easy to find. The
package imports neither ``jax`` nor ``ptyrad_tpu``.
"""

__version__ = "0.1.0"

from ptyrad_tpu_torch.engine.solver import PtyRADSolver  # noqa: F401
from ptyrad_tpu_torch.models.state import Buffers, Geometry, PtychoParams  # noqa: F401
