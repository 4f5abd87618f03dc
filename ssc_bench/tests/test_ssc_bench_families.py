"""Model families, found by name from the configuration's ``"family"``
key: the StereoScene family reads what the harness read before families
existed, a second family is taken from new files alone, and the training
harness runs the program as its configuration states."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ssc_bench import families, flops, generate, harness, serve, training
from ssc_bench.families import stereoscene

from .conftest import HERE, ROOT

TOY = os.path.join(HERE, "toy_family")
# the harness's readings of tiny.json before it reached the model through
# families (2 threads on the CPU): the weight spec and the seed-11 weights
# (sha256 over each tensor's name and bytes in spec order), the FLOPs of a
# frame, and every number of the serving (seed 2**31 + 12345, a pool of one
# frame, so that any window answers it) and training (seed 3) comparisons
PARENT = {
    "spec": (652, "1dbe5e63a0be17998e32d1e27a8d07cff375066cf680e77e"
                  "4bb5638ca47faeca"),
    "weights": "94ecdb15c342f7996b94db29dd1f80068de179faa0110919b4c6c7878"
               "77cff61",
    "flops": 2080376192,
    "serve": {"depth_gap": 6.83940015733242e-09,
              "logit_gap": 8.12705536645808e-07, "class_gap": 0.0},
    "train": {"stage2_gap": 0.0, "logit1_gap": 0.0,
              "loss_gap": 7.468971093214627e-07, "loss1_gap": 0.0,
              "grad_gap": 4.75844167379772e-06,
              "grad_median": 1.252736668853022e-07,
              "change_gap": 0.009537788348955887,
              "change_median": 0.0003579461639333204,
              "change_p98": 0.004273389435479525},
}


@pytest.fixture
def tiny():
    torch.set_num_threads(2)
    with open(os.path.join(HERE, "tiny.json")) as f:
        return json.load(f)


def test_default_family_is_stereoscene(tiny):
    assert "family" not in tiny
    assert families.of(tiny) is stereoscene
    assert families.of(dict(tiny, family="stereoscene")) is stereoscene


def test_weights_and_flops_read_as_the_parent(tiny):
    spec = harness.weight_spec(tiny)
    assert (len(spec), hashlib.sha256(json.dumps(spec).encode())
            .hexdigest()) == PARENT["spec"]
    state = harness.seeded_weights(tiny, 11, "cpu", spec)
    digest = hashlib.sha256()
    for name, _ in spec:
        digest.update(name.encode())
        digest.update(state[name].numpy().tobytes())
    assert digest.hexdigest() == PARENT["weights"]
    assert flops.forward_flops(tiny, 1) == PARENT["flops"]


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_checks_read_as_the_parent(tiny_cell, kind):
    from ssc_bench import check

    if kind == "serve":
        cell = tiny_cell("kitti-serve-stream", pool=1, warmup_frames=1,
                         check_frames=1)
        cell.limits = dict.fromkeys(stereoscene.SERVE_NUMBERS, float("inf"))
        out = serve.run(cell, 2 ** 31 + 12345, 0.5, False, "cpu",
                        time.time())
    else:
        cell = tiny_cell("kitti-train-b2", batches=4)
        cell.limits = dict.fromkeys(check.train_numbers(stereoscene),
                                    float("inf"))
        out = training.run(cell, 3, 0.3, False, "cpu", time.time())
    read = {k: c["value"] for k, c in out.checks.items()}
    assert {k: read[k] for k in PARENT[kind]} == PARENT[kind]
    # the stages judged alone are new: float32 rounding here
    new = set(read) - set(PARENT[kind])
    assert new == (set(stereoscene.STAGE_NUMBERS) if kind == "train"
                   else set())
    assert all(read[k] < 1e-5 for k in new)


@pytest.mark.parametrize("workload", ["highres-train-b1", "kitti-train-b2"])
def test_training_runs_the_configuration_as_it_stands(tiny_cell, monkeypatch,
                                                      workload):
    built = []
    build = harness.build_program

    def recording(config, device):
        built.append(config)
        return build(config, device)

    monkeypatch.setattr(harness, "build_program", recording)
    cell = tiny_cell(workload, batches=3)
    out = training.run(cell, 9, 0.2, False, "cpu", time.time())
    assert out.correct, out.checks
    (config,) = built
    assert config is cell.config


def test_reference_recompute_leaves_the_gradient(tiny):
    """The reference recomputes its image blocks and voxel side on a card,
    to fit: the same loss and gradient bit for bit."""
    m = tiny["model"]
    with open(os.path.join(ROOT, "ssc_bench/traffic/train_b2.json")) as f:
        traffic = dict(json.load(f), batches=1)
    batch = generate.train_batches(traffic, m["input_size"],
                                   tiny["label_shape"], m["dbound"], 4,
                                   "cpu")[0]
    state = harness.seeded_weights(tiny, 4, "cpu")
    grads = []
    for recompute in (False, True):
        ref = stereoscene.build_reference(m, "cpu",
                                          checkpoint_blocks=recompute)
        assert ref.checkpoint_voxels is recompute
        harness.load_weights(ref, state)
        ref.train()
        loss = sum(stereoscene.reference_losses(
            ref(batch, generate.step_generator(4, 0, "cpu")), batch,
            tiny).values())
        grads.append([loss] + list(torch.autograd.grad(
            loss, list(ref.parameters()), allow_unused=True)))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)


# ------------------------------------------------ a family from new files

RUN_TOY = """
import json, sys, time
sys.path.insert(0, ".")
import torch
torch.set_num_threads(2)
from ssc_bench import flops, harness, serve, training
from ssc_bench.cell import load

def unchanged_state(step):
    def broken(state, batch, generator=None):
        saved = [p.detach().clone() for _, p in state.trainable]
        state, logs = step(state, batch, generator)
        for (_, p), s in zip(state.trainable, saved):
            p.data.copy_(s)
        return state, logs
    return broken

out = {}
for name, workload, runner, kw in [
        ("serve", "toy-serve-stream", serve, {}),
        ("serve_broken", "toy-serve-stream", serve,
         {"break_answer": lambda c: (c + 1) % 20}),
        ("train", "toy-train", training, {}),
        ("train_broken", "toy-train", training,
         {"break_step": unchanged_state})]:
    cell = load(".", workload)
    o = runner.run(cell, 2 ** 31 + 7, 0.3, False, "cpu", time.time(), **kw)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    out[name] = json.loads(harness.result_line(o, units, 1, "cpu", False))
out["flops"] = flops.forward_flops(load(".", "toy-train").config, 1)
out["forbidden"] = harness.forbidden_modules()
print(json.dumps(out))
"""


def _toy_tree(root):
    """A checkout with the toy family added as new files: the benchmark's
    files copied as they are, then the family module, its reference, its
    configuration, its traffic, its limits and entries in BENCHMARK.json;
    ``toy_program.py`` stands in for the port's model."""
    bench_dir = os.path.join(root, "ssc_bench")
    shutil.copytree(os.path.join(ROOT, "ssc_bench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {os.path.relpath(os.path.join(d, f), bench_dir)
              for d, _, fs in os.walk(bench_dir) for f in fs}
    added = {"families/toy.py": "family.py", "reference/toy.py":
             "reference.py", "configs/toy.json": "config.json",
             "limits/toy-serve-stream.json": "limits_serve.json",
             "limits/toy-train.json": "limits_train.json"}
    for dest, src in added.items():
        assert not os.path.exists(os.path.join(bench_dir, dest))
        shutil.copy(os.path.join(TOY, src), os.path.join(bench_dir, dest))
    shutil.copy(os.path.join(TOY, "program.py"),
                os.path.join(root, "toy_program.py"))
    for name, base, sizes in [
            ("toy_stream", "camera_stream",
             {"pool": 2, "warmup_frames": 1, "check_frames": 2}),
            ("toy_train", "train_b2", {"batches": 4})]:
        with open(os.path.join(bench_dir, "traffic", base + ".json")) as f:
            traffic = dict(json.load(f), **sizes)
        with open(os.path.join(bench_dir, "traffic", name + ".json"),
                  "w") as f:
            json.dump(traffic, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy", "source": "test fixture",
                             "file": "ssc_bench/configs/toy.json",
                             "reduced": [], "why": "a second family"})
    cells = {"toy-serve-stream": "toy_stream", "toy-train": "toy_train"}
    for cell, traffic in cells.items():
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": traffic, "chips": 1,
                                   "why": "a second family"})
    for m in bench["end_to_end"]:
        kind = {"frames_per_s": "toy-serve-stream",
                "frame_ms_p95": "toy-serve-stream",
                "train_frames_per_s": "toy-train",
                "train_peak_gib": "toy-train"}.get(m["name"])
        if kind:
            m["workloads"].append(kind)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return before


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    before = _toy_tree(root)
    proc = subprocess.run([sys.executable, "-c", RUN_TOY], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return root, before, json.loads(proc.stdout.strip().splitlines()[-1])


def test_new_family_edits_no_file(toy_run):
    root, before, _ = toy_run
    for rel in before:
        with open(os.path.join(ROOT, "ssc_bench", rel), "rb") as a, \
                open(os.path.join(root, "ssc_bench", rel), "rb") as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize("run,correct", [("serve", True),
                                         ("serve_broken", False),
                                         ("train", True),
                                         ("train_broken", False)])
def test_new_family_is_judged(toy_run, run, correct):
    line = toy_run[2][run]
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def test_new_family_counts_flops_and_loads_nothing_forbidden(toy_run):
    out = toy_run[2]
    # 3x3 conv 6 -> 8 on 16x32 and 1x1 conv 8 -> 80 on 8x8, 2 a MAC
    assert out["flops"] == 2 * (16 * 32 * 8 * 6 * 9 + 8 * 8 * 80 * 8)
    assert out["forbidden"] == []
