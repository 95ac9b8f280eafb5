"""The package runs wherever JAX does: no module of it reaches for a
backend-specific kernel interface, an interpreter fallback, or a gate on
an accelerator's name."""

import ast
import os
import pathlib
import re

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "melonix_tpu"
MODULES = sorted(PKG.rglob("*.py"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_module_has_no_backend_specific_kernels(path):
    src = path.read_text()
    mods = set(_imports(ast.parse(src)))
    assert not any(m.startswith("jax.experimental.pallas") for m in mods), mods
    for word in ("pallas", "interpret="):
        assert word not in src, (path.name, word)
    # The only backend test allowed is "is this the CPU" (tests skip
    # accelerator warm-ups there); no path may hinge on a device name.
    assert not re.search(r'default_backend\(\)\s*[!=]=\s*"(?!cpu")', src), path.name


def test_kernels_package_is_gone():
    assert not (PKG / "kernels").exists()
    assert os.path.isdir(PKG / "engine")
