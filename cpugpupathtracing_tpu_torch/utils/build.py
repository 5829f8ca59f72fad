"""Where the port's compiled artifacts go: `build/` beside the package
(listed in .gitignore), one subdirectory per source hash, so an edited
source never loads a stale library and a clean checkout builds afresh."""

from __future__ import annotations

import hashlib
import os

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build")


def source_path(*parts: str) -> str:
    """Absolute path of a file inside the package."""
    return os.path.join(_PKG_DIR, *parts)


def hashed_dir(kind: str, sources: list[str], flags: list[str]) -> str:
    """build/<kind>/<hash of the sources' bytes and the flags>/ (created)."""
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    out = os.path.join(BUILD_ROOT, kind, h.hexdigest()[:16])
    os.makedirs(out, exist_ok=True)
    return out
