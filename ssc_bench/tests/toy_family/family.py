"""The toy family: ``toy_program.ToyOcc`` against ``reference/toy.py``.
Installed as ``ssc_bench/families/toy.py``; its numbers are the voxel
logits' relative RMS gap and the served classes' widest logit gap."""

from __future__ import annotations

from typing import Dict

import torch

from ..check import rms
from ..reference import toy as reference

DAMPED = ()
SERVE_OUTPUTS = {"logits": ("", lambda out: out)}
STAGES = ()
SERVE_NUMBERS = ("logit_gap", "class_gap")
FIRST_OUTPUTS = {"enc": "encoder", "logit1": "head"}

build_reference = reference.build


def build_program(config: Dict, device):
    from toy_program import ToyOcc

    with torch.device(device):
        return ToyOcc(config["model"], config["label_shape"])


def num_classes(config: Dict) -> int:
    return config["model"]["classes"]


def classes_of(outputs, label_shape):
    return reference.upsample(outputs["logits"], label_shape).argmax(1)


@torch.no_grad()
def serve_frame(prog, ref, classes, label_shape) -> Dict[str, float]:
    up = reference.upsample(ref["logits"], label_shape)[0]
    cls = classes.to(up.device).long()[0]
    if tuple(cls.shape) != tuple(label_shape):
        return dict.fromkeys(SERVE_NUMBERS, float("inf"))
    served = up.gather(0, cls[None])[0]
    lp, lr = prog["logits"].float(), ref["logits"]
    return {"logit_gap": float(rms(lp - lr) / rms(lr)),
            "class_gap": float((up.amax(0) - served).max())
            / float(ref["logits"].abs().max())}


def train_program(model, config: Dict, device):
    from toy_program import train_program as program

    opt = config["optimizer"]
    return program(model, opt["lr"], opt["weight_decay"], opt["grad_clip"])


def reference_losses(outputs, batch, config: Dict):
    up = reference.upsample(outputs["logits"], batch["gt_occ"].shape[1:])
    return {"loss_ce": reference.cross_entropy(up, batch["gt_occ"])}


def flop_inputs(net, model_cfg: Dict, batch: int):
    h, w = model_cfg["input_size"]
    return ({"imgs": torch.empty(batch, 2, h, w, 3)},), {}
