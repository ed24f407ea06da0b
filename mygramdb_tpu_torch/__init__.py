"""MygramDB on PyTorch + CUDA: the device plane of ``mygramdb_tpu`` ported
to one NVIDIA H100.

The JAX package stays the reference. This package imports ``torch`` and
never ``jax``: it owns the device modules (``ops``, ``index.device_index``,
``server.microbatch``, the device rows of ``storage.filter_index``) and runs
every host module of the JAX package under its own name (see
``_overlay.py``). Hand-written CUDA kernels live in ``csrc/``.
"""

import mygramdb_tpu as _host

from ._overlay import HOST_ROOT

__path__.append(HOST_ROOT)
__version__ = _host.__version__
