"""cara_tpu_torch: the PyTorch / CUDA port of :mod:`cara_tpu`.

The package mirrors ``cara_tpu``'s layout file for file, so every module
here has one counterpart in the JAX reference package.  What exists so far
is the serving slice: configs, the eval ViT forward with CaRA adapters
(merged or kept), npz checkpoints, the ``Predictor``, the micro-batching
HTTP server and its CLI.  Three hand-written CUDA kernels
(``ops/cuda``, sources in ``csrc/``) replace the TPU kernels this path
runs; each has a plain PyTorch twin that CPU tensors take.

Importing the package needs neither a GPU nor ``nvcc``: the kernels are
compiled on first use (``ops/cuda/_build.py``).
"""

__version__ = "0.1.0"
