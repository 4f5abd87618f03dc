"""What the harness loads: no JAX and nothing of the JAX package where a
run drives the program or a family module is imported, and nothing of the
program in the references and the benchmark's yardsticks. Each case runs
in a fresh interpreter and compares top-level module names whole
(``stereoscene_torch`` begins with the JAX package's name and is not
it)."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "stereoscene_tpu"]



def modules(folder):
    """Every module of ``ssc_bench/<folder>`` (a family or reference that
    a later change adds is held to the same)."""
    return [f"ssc_bench.{folder}.{name[:-3]}" for name in
            sorted(os.listdir(os.path.join(ROOT, "ssc_bench", folder)))
            if name.endswith(".py") and name != "__init__.py"]


IMPORT = "import importlib\nfor m in {!r}:\n    importlib.import_module(m)\n"
REFERENCE = IMPORT.format(modules("reference")) + """
from ssc_bench import check, flops, generate, roofline, weights
"""
FAMILIES = IMPORT.format(modules("families"))

RUN = """
import json, time, torch
from ssc_bench import harness, serve, training
from ssc_bench.cell import Cell, load
with open("ssc_bench/tests/tiny.json") as f:
    config = json.load(f)
base = load(".", "kitti-serve-stream")
base.traffic.update(pool=2, warmup_frames=1, check_frames=1)
serve.run(Cell("s", 1, config, base.traffic, base.end_to_end, [], {}), 1,
          0.2, False, "cpu", time.time())
base = load(".", "kitti-train-b2")
base.traffic.update(batches=3)
training.run(Cell("t", 1, config, base.traffic, base.end_to_end, [], {}),
             1, 0.2, False, "cpu", time.time())
"""


def loaded(code):
    probe = (code + "\nimport sys, json\nprint(json.dumps(sorted({m.split("
             "'.')[0] for m in list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("code,absent", [
    (REFERENCE, FORBIDDEN + ["stereoscene_torch"]),
    (RUN, FORBIDDEN),
    (FAMILIES, FORBIDDEN),
], ids=["reference", "run", "families"])
def test_modules_loaded(code, absent):
    names = loaded(code)
    assert not names & set(absent), sorted(names & set(absent))
    if code is RUN:
        assert "stereoscene_torch" in names
    if code is FAMILIES:
        assert "stereoscene" in {m.rsplit(".", 1)[1]
                                 for m in modules("families")}


def test_forbidden_names_compare_whole(monkeypatch):
    from ssc_bench import harness

    monkeypatch.setitem(sys.modules, "stereoscene_tpu_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]
