"""Names of the JAX package's device plane that the port does not carry.

A placeholder module raises NotImplementedError naming why, so a caller
learns that the name exists only in the JAX package (``ops/wire.py``, the
TPU tunnel's transport).
"""

from __future__ import annotations


def placeholder_getattr(module: str, item: str):
    """Module ``__getattr__`` for a placeholder: any name the module does
    not define raises NotImplementedError."""
    def __getattr__(name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(
            f"{module}.{name} is not ported to PyTorch "
            f"(ROADMAP Queue 1, item {item})")
    return __getattr__
