"""No file of the port imports JAX or the JAX package: every ``.py`` file
of ``stereoscene_torch/`` and ``chip_smoke.py`` is parsed with ``ast`` and
fails on an ``import`` or ``from`` of ``jax``, ``flax``, ``optax``,
``orbax`` or ``stereoscene_tpu``, wherever it stands (inside a function
too). Names in docstrings and comments do not count.

Nor does it read the JAX package's files: no string of a port module
other than a docstring names ``stereoscene_tpu``; the native host library
builds from the port's own ``native/kitti_host.cc``, which includes only
system headers, into the port's build directory; and the port's CLIs
import of the repo's ``tools/`` only ``tools.data_converter``, which
imports neither model package."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "flax", "optax", "orbax", "stereoscene_tpu"}
PORT = sorted(p.relative_to(ROOT).as_posix()
              for p in (ROOT / "stereoscene_torch").rglob("*.py"))
FILES = PORT + ["chip_smoke.py"]


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


def test_the_guard_covers_the_measurement_tools():
    tools = {"stereoscene_torch/tools/bench_train.py",
             "stereoscene_torch/tools/highres_slice.py",
             "stereoscene_torch/tools/_frames.py"}
    assert tools <= set(FILES)


@pytest.mark.parametrize("path", FILES)
def test_port_file_imports_no_jax(path):
    source = (ROOT / path).read_text()
    bad = [(root, line) for root, line in imported_roots(source)
           if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _strings(source: str):
    """(string, line) of every string constant that is not a docstring."""
    tree = ast.parse(source)
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value, node.lineno


@pytest.mark.parametrize("path", PORT)
def test_port_file_reads_nothing_of_the_jax_package(path):
    source = (ROOT / path).read_text()
    bad = [line for text, line in _strings(source)
           if "stereoscene_tpu" in text]
    assert not bad, f"{path} names stereoscene_tpu at lines {bad}"
    tools = [root for root, _ in imported_roots(source) if root == "tools"]
    if tools:
        assert all(mod.startswith("tools.data_converter")
                   for mod in _tool_modules(source)), path


def _tool_modules(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names if a.name.startswith(
                "tools"))
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module.startswith("tools")):
            yield node.module


def test_native_library_is_the_ports_own():
    from stereoscene_torch import native

    port = ROOT / "stereoscene_torch"
    assert native.SRC == port / "native" / "kitti_host.cc"
    assert native.SRC.is_file()
    assert native.BUILD_DIR == port / "_kernels_build"
    includes = [line for line in native.SRC.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all("<" in line for line in includes), includes
