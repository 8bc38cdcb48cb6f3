"""The kernel build cache: where the CUDA library is built and found
(the counterpart of ``cara_tpu/utils/jit_cache.py``, the persistent XLA
compilation cache).

The port compiles no XLA program; what a fresh process pays for on the
card is the first-use ``nvcc`` build of ``cara_tpu_torch/csrc`` (67-98 s
on one H100 80GB HBM3, 700 W, ``chip_smoke.py``).  The build keeps its
library and a stamp (a hash of the sources and flags) in
``ops.cuda._build.BUILD_DIR``, ``build/kernels`` under the repository by
default, and loads that library without building when the stamp
matches.  :func:`enable_compilation_cache` points the build at another
directory, so that runs from other checkouts or working directories
share one built library: ``--compilation-cache DIR``, or
``$CARA_JIT_CACHE``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from cara_tpu_torch.ops.cuda import _build


def enable_compilation_cache(path: Optional[str] = None) -> str:
    """Point the kernel build at ``path``, else at ``$CARA_JIT_CACHE``
    (unless it is "0" or empty, which keep the default); return the build
    directory.  It must run before the first kernel call of the process,
    which builds or loads the library; a later call that would move it
    raises."""
    env = os.environ.get("CARA_JIT_CACHE")
    path = path or (env if env and env != "0" else None)
    if path is None:
        return str(_build.BUILD_DIR)
    target = Path(path).expanduser().resolve()
    if _build._lib is not None and target != _build.BUILD_DIR:
        raise RuntimeError(
            f"the kernel library is already loaded from {_build.BUILD_DIR}; "
            "set the compilation cache before the first kernel call")
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    return str(target)
