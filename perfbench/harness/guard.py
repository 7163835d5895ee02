"""What a run may load: never JAX nor the JAX package, and a reference that
loads nothing of the program.

Names are compared by their top-level part (before the first dot) as a
whole: the port's package name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "sim_a_splat_tpu")
PROGRAM = "sim_a_splat_torch"
REFERENCE_DIR = Path(__file__).resolve().parent.parent / "reference"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    """Top-level names in ``modules`` (default ``sys.modules``) that a run
    may not hold."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))


def imports_of(path: Path) -> set:
    """Top-level names of the modules a source file imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(top_level(node.module))
    return found


def reference_violations(ref_dir: Path = REFERENCE_DIR) -> list:
    """(file, name) pairs where the reference imports the program, JAX or
    the JAX package."""
    bad = set(FORBIDDEN) | {PROGRAM}
    return sorted((p.name, n) for p in ref_dir.glob("*.py")
                  for n in imports_of(p) & bad)
