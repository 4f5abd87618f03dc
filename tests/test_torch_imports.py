"""No file of the port imports JAX or the JAX package: every ``.py`` file
of ``stereoscene_torch/`` and ``chip_smoke.py`` is parsed with ``ast`` and
fails on an ``import`` or ``from`` of ``jax``, ``flax``, ``optax``,
``orbax`` or ``stereoscene_tpu``, wherever it stands (inside a function
too). Names in docstrings and comments do not count."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "optax", "orbax", "stereoscene_tpu"}
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "stereoscene_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def imported_roots(source: str):
    """The top-level package of every absolute import in ``source``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_the_guard_sees_every_form():
    src = ("import numpy\nimport jax.numpy as jnp\n"
           "def f():\n    from flax import linen\n"
           "from stereoscene_tpu.core import bbox3d\nfrom . import x\n")
    assert sorted((r, n) for r, n in imported_roots(src)
                  if r in FORBIDDEN) == [("flax", 4), ("jax", 2),
                                         ("stereoscene_tpu", 5)]


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    source = (ROOT / path).read_text()
    bad = [(root, line) for root, line in imported_roots(source)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
