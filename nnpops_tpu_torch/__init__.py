"""nnpops_tpu_torch: the PyTorch + CUDA (Hopper) port of ``nnpops_tpu``.

The JAX package ``nnpops_tpu`` stays the reference; this package mirrors its
public names and layouts module by module (``neighbors.blocked``,
``ops.aev_blocked``, ``models.ani``, ...) so a reader finds each
counterpart. Every Pallas TPU kernel on a ported path is a hand-written CUDA
C++ kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``_kernels.py``); each kernel's wrapper runs the kernel on a CUDA tensor and
its plain PyTorch version on a CPU tensor.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the numpy-only configuration
(``config.py``), water builders and file loaders (``utils/``) and the
native host loader (``native/``).
"""
import torch

from .config import ANI2X_ELEMENTS, ANI2X_LAYER_DIMS, ANIBasis

# Box products (fractional coordinates, minimum-image wraps) must run in true
# f32: a reduced-precision box once put 0.03 A errors on wrapped atoms in
# the reference. TF32 keeps ~3 decimal digits, so it is off for both
# matmuls and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The first multithreaded CPU torch.sqrt of a process can return values
# accurate to only ~2^-12 on one thread's share of the elements (seen with
# PyTorch's MKL / AVX-512 CPU build, in about one process in ten; every
# later call is exact). That moved the payload distances by up to 1.2e-3 A.
# One throwaway call, large enough to run on every thread, takes that first
# call here.
torch.sqrt(torch.ones(1 << 20))

__version__ = '0.1.0'
__all__ = ['ANIBasis', 'ANI2X_ELEMENTS', 'ANI2X_LAYER_DIMS']
