"""The benchmark measures the PyTorch port and nothing of the JAX package.

Names are compared by their top-level part (before the first dot), whole:
the port's package ``skybox_rt_tpu_torch`` begins with the JAX package's
name but is not it.
"""
from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "skybox_rt_tpu"})
#: what the plain references may not load besides: the program itself
PROGRAM = "skybox_rt_tpu_torch"
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def loaded() -> list:
    """Forbidden top-level modules in this process's sys.modules."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _imports(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def source_findings(bench_dir: str = BENCH_DIR) -> list:
    """Every import under bench_dir of a forbidden module, and of the program
    from a file under ``reference/``: [(path, module), ...]."""
    out = []
    for root, _, files in os.walk(bench_dir):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, bench_dir)
            banned = FORBIDDEN
            if rel.split(os.sep)[0] == "reference":
                banned = FORBIDDEN | {PROGRAM}
            out += [(rel, m) for m in sorted(_imports(path) & banned)]
    return out
