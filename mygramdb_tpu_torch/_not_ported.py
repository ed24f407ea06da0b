"""Names of the JAX package's device plane that the port does not have yet.

A placeholder module or method raises NotImplementedError naming its
ROADMAP item, so a caller learns which slice of the port it waits for.
"""

from __future__ import annotations


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
    not define raises NotImplementedError."""
    def __getattr__(name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise NotImplementedError(_message(module, name, item))
    return __getattr__
