"""Overlay of the JAX package's host modules under this package's name.

The port owns the device plane only. Every host module (parser, pipeline,
catalog, servers, builder, delta overlay, ...) is the JAX package's own
source file, executed under ``mygramdb_tpu_torch.*``: each port package
appends its JAX counterpart's directory to ``__path__``, so a module the
port does not define is found there, and its relative imports
(``from ..ops import runtime``) land on the port's modules.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import mygramdb_tpu as _host_root

HOST_ROOT = os.path.dirname(os.path.abspath(_host_root.__file__))


def extend_path(path, name: str) -> list:
    """``__path__`` of port package ``name`` followed by the directory of
    the JAX package's package of the same relative name."""
    rel = name.split(".")[1:]
    return list(path) + [os.path.join(HOST_ROOT, *rel)]


def load_host_module(name: str, relpath: str):
    """Execute the JAX package's source file ``relpath`` as module ``name``
    (a private module inside this package), so that its relative imports
    resolve to this package's modules."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HOST_ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _message(module: str, name: str, item: str) -> str:
    return (f"{module}.{name} is not ported to PyTorch yet "
            f"(ROADMAP Queue 1, item {item})")


def not_ported(module: str, name: str, item: str):
    """A callable that raises NotImplementedError naming its ROADMAP item."""
    def stub(*_args, **_kwargs):
        raise NotImplementedError(_message(module, name, item))
    stub.__name__ = stub.__qualname__ = name
    return stub


def placeholder_getattr(module: str, item: str):
    """Module ``__getattr__`` for a placeholder: any name the module does
    not define raises NotImplementedError, so host code can never fall
    through to the JAX package's device code under the port's name."""
    def __getattr__(name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(_message(module, name, item))
    return __getattr__
