"""MygramDB on PyTorch + CUDA: the port of ``mygramdb_tpu`` to one NVIDIA
H100.

The JAX package stays the reference. This package imports ``torch`` and
never ``jax``, and nothing of the JAX package: it keeps its own copy of
every host module (parser, pipeline, catalog, servers, builder, delta
overlay, replication, ...) at the same relative path, and its own device
modules (``ops``, ``index.device_index``, ``storage.device_text``,
``server.microbatch``, ...). Hand-written CUDA kernels live in ``csrc/``.
"""

__version__ = "0.1.0"
