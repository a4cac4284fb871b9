"""stark_tpu_torch — the PyTorch/CUDA port of stark_tpu.

The same simulator as `stark_tpu` (one global incremental potential per time
step, minimized by projected Newton with a matrix-free block-preconditioned
CG and a 4-stage line search), written in PyTorch for one NVIDIA Hopper card.
Per-element derivatives come from `torch.func`; the hot device operations
(segmented reductions, the CG Hessian-vector product, the batched Jacobi PD
projection and the 3x3 block preconditioner) are CUDA C++ kernels under
`csrc/`, built with nvcc at first use, each beside a plain-PyTorch twin that
is its CPU path and its test oracle (`ops/`).

Entry points run on `cuda` unless the settings ask for the CPU
(`settings.device.device = "cpu"`). The package never changes torch's global
default dtype: every tensor carries the dtype of `settings.device.dtype`.
"""
from .core.settings import Settings  # noqa: F401
from .simulation import Simulation  # noqa: F401

__version__ = "0.1.0"
