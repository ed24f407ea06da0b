"""Safe file path resolution with traversal protection.

Mirror of the reference's ``utils/safe_path.h`` ``ResolveSafePath``
contract (used by the DUMP * and CONFIG VERIFY handlers to stop path
traversal / arbitrary file access from network commands):

1. Absolute input is used as-is; relative input is joined with
   ``base_dir``.
2. Both the resolved path and ``base_dir`` are canonicalized
   (``os.path.realpath`` — resolves symlinks on the existing prefix and
   lexically collapses the rest, the analog of
   ``std::filesystem::weakly_canonical``).
3. The canonical resolved path must lie inside the canonical
   ``base_dir`` (no ``..`` escape, no symlink escape).
4. If ``allowed_extensions`` is non-empty the resolved file's extension
   must match one (case-insensitive, leading dot included).

Raises ``MygramError(INVALID_ARGUMENT)`` on violation; callers wrap it
into their domain error (DumpError etc.).
"""

from __future__ import annotations

import os
from typing import Sequence

from .errors import ErrorCode, MygramError


def resolve_safe_path(input_path: str, base_dir: str,
                      allowed_extensions: Sequence[str] = (),
                      base_dir_label: str = "base directory") -> str:
    """Resolve ``input_path`` to an absolute path guaranteed to be inside
    ``base_dir``. See module docstring for the contract (reference
    safe_path.h:22-58)."""
    if not input_path:
        raise MygramError(ErrorCode.INVALID_ARGUMENT, "empty path")
    if not base_dir:
        raise MygramError(ErrorCode.INVALID_ARGUMENT,
                          f"empty {base_dir_label}")
    base_canon = os.path.realpath(base_dir)
    candidate = (input_path if os.path.isabs(input_path)
                 else os.path.join(base_canon, input_path))
    resolved = os.path.realpath(candidate)
    # containment: the canonical path must equal base or live under it
    if resolved != base_canon and \
            not resolved.startswith(base_canon + os.sep):
        raise MygramError(
            ErrorCode.INVALID_ARGUMENT,
            f"path must be within {base_dir_label}: {input_path!r}")
    if allowed_extensions:
        ext = os.path.splitext(resolved)[1].lower()
        allowed = {e.lower() for e in allowed_extensions}
        if ext not in allowed:
            raise MygramError(
                ErrorCode.INVALID_ARGUMENT,
                f"disallowed file extension {ext!r} (allowed: "
                f"{', '.join(sorted(allowed))})")
    return resolved
