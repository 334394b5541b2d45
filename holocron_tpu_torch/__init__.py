"""holocron-tpu-torch: the PyTorch/CUDA port of ``holocron_tpu`` for an NVIDIA H100.

The JAX package ``holocron_tpu`` is the reference; this package mirrors its module
paths so that each counterpart is found under the same name. Models take NCHW input
(``channels_last`` on the card) and keep the original Holocron ``state_dict`` layout.
Every Pallas kernel of the JAX package on a ported path becomes a CUDA kernel written
for Hopper (``csrc/``), built with ``nvcc`` on first use (:mod:`.kernels._build`).
Importing the package builds nothing and imports no JAX.
"""

from . import convert, kernels, models, nn, ops, optim, quant, trainer

__version__ = "0.1.0.dev0"
