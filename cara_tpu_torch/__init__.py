"""cara_tpu_torch: the PyTorch / CUDA port of :mod:`cara_tpu`.

The package mirrors ``cara_tpu``'s layout file for file, so every module
here has one counterpart in the JAX reference package.  What exists so far
is the serving slice (configs, the eval ViT forward with CaRA adapters
merged or kept, npz checkpoints, the ``Predictor``, the micro-batching
HTTP server and its CLI) and the default training path (the training
forward with exact element-wise weight dropout and drop-path, the train
and eval steps, AdamW with the CaRA schedule, the fit loop, VTAB data,
the npz backbone loader and the ``vit_cp`` CLI), then the other training
routes, the CLIs (``vit_cp``, ``dim_experiment``, ``serve``, ``export``,
``predict``), multi-task serving and the importers and exporter of torch
checkpoints (``models/torch_import.py``, ``torch_export.py``,
``clip_import.py``); ``ROADMAP.md`` lists what is left.  Hand-written CUDA
kernels (``ops/cuda``, sources in ``csrc/``) replace the TPU kernels these
paths run; each has a plain PyTorch twin that CPU tensors take.

Importing the package needs neither a GPU nor ``nvcc``: the kernels are
compiled on first use (``ops/cuda/_build.py``).
"""

__version__ = "0.1.0"
