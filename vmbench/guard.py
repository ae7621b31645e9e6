"""The import guard: a run fails if the process holds JAX or the JAX
package, and the plain reference may import nothing of the program.

Names are compared by their whole top-level part (before the first
dot), so ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROGRAM = "repro_torch"
HERE = Path(__file__).resolve().parent
# the yardstick's modules, and every metric reader in ``metrics/``: none
# may import the program, JAX or the JAX package
YARDSTICK = ("reference.py", "data.py", "roofline.py", "devtrace.py")


def yardstick_files() -> List[str]:
    """The yardstick's files, relative to this folder."""
    readers = sorted(p.relative_to(HERE).as_posix()
                     for p in (HERE / "metrics").glob("*.py"))
    return list(YARDSTICK) + readers


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level part is a forbidden name."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """Top-level names that a source file imports (absolute imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return sorted(out)


def yardstick_imports() -> dict:
    """Each yardstick module's imports; raises if one takes the program,
    JAX or the JAX package."""
    out = {}
    for name in yardstick_files():
        mods = imports_of(HERE / name)
        bad = [m for m in mods if m in FORBIDDEN or m == PROGRAM]
        if bad:
            raise RuntimeError(f"vmbench/{name} imports {bad}")
        out[name] = mods
    return out
