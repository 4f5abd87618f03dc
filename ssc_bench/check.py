"""The numbers that decide ``correct``, each against its limit.

Serving (per sampled frame, the worst over the sample):

- ``depth_gap``: the total variation distance between the program's
  fused depth distribution and the reference's, averaged over the
  pixels (half the summed absolute gap over the depth bins);
- ``logit_gap``: the root-mean-square gap between the program's voxel
  logits and the reference's, over the reference logits' root mean
  square;
- ``class_gap``: at each voxel of the served class map, how far the
  reference's logit for the served class (the reference's logits
  upsampled to the label grid) lies below its best, over the reference's
  largest logit magnitude; the widest such gap. A flip between two
  near-equal logits reads about the logits' rounding; a wrong answer
  reads the logits' spread.

The first two are means, not widest gaps: a few pixels whose depth
softmax is nearly tied move by most of a probability under any rounding,
so the widest gap of a sound bfloat16 run reached what float8 reads.

Training (the first ``check_steps`` steps, which set-up drives through the
window's own step and feed):

- ``loss_gap``: the widest relative gap between the program's and the
  reference's total loss over those steps;
- ``grad_gap``: per parameter tensor (leaf), the gap between the norms of
  the first step's clipped gradient, over the larger of the reference
  leaf's norm and the median leaf's; the worst leaf (``grad_median``: the
  median leaf);
- ``change_gap``: the gap of norms of each leaf's change after the steps,
  over the leaves whose first reference gradient is at least a thousandth
  of the median leaf's (a leaf below that, a key's bias under softmax,
  moves under Adam by round-off alone); the worst leaf
  (``change_median``: the median leaf; ``change_p98``: the 98th
  percentile leaf, so that no more than one leaf in fifty may read above
  its limit).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from .reference import model as reference

# every number a serving or training comparison reads; the configuration's
# limits name those that decide ``correct``
SERVE_NUMBERS = ("depth_gap", "logit_gap", "class_gap")
TRAIN_NUMBERS = ("stage2_gap", "logit1_gap", "loss_gap", "loss1_gap",
                 "grad_gap", "grad_median", "change_gap", "change_median",
                 "change_p98")
# the outputs of the first training step that the comparison reads: the
# image backbone's stage 2 (its first feature map, stride 8) and the logits
FIRST_OUTPUTS = {"stage2": "img_backbone.layers.2", "logits": "pts_bbox_head"}


class FirstOutputs:
    """Forward hooks that keep the first output of each module of
    ``FIRST_OUTPUTS`` (a checkpointed block's recompute comes later)."""

    def __init__(self, model):
        self.out: Dict[str, torch.Tensor] = {}
        self.handles = []
        for key, path in FIRST_OUTPUTS.items():
            module = model.get_submodule(path)
            if isinstance(module, torch.nn.Sequential):
                module = module[-1]  # a stage: its last block
            self.handles.append(module.register_forward_hook(
                self._keeper(key)))

    def _keeper(self, key):
        def hook(_module, _inputs, out):
            if key not in self.out:  # returns None: the output stands
                self.out[key] = out.detach().float()
        return hook

    def remove(self) -> Dict[str, torch.Tensor]:
        for h in self.handles:
            h.remove()
        return self.out


@torch.no_grad()
def serve_frame(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                classes: torch.Tensor, label_shape) -> Dict[str, float]:
    """Gaps of one frame: ``prog`` holds the program's ``logits`` [1, C, X,
    Y, Z] and ``depth_prob``, ``ref`` the reference's, ``classes`` the
    served class map [1, *label_shape] (any device)."""
    scale = float(ref["logits"].abs().max())
    up = reference.upsample(ref["logits"], label_shape)[0]  # [C, ...]
    cls = classes.to(up.device).long()[0]
    num = up.shape[0]
    if tuple(cls.shape) != tuple(label_shape) or int(cls.min()) < 0 \
            or int(cls.max()) >= num:
        return dict.fromkeys(SERVE_NUMBERS, float("inf"))
    served = up.gather(0, cls[None])[0]
    dp, dr = prog["depth_prob"].float(), ref["depth_prob"]
    lp, lr = prog["logits"].float(), ref["logits"]
    return {"depth_gap": float(0.5 * (dp - dr).abs().sum(1).mean()),
            "logit_gap": float(_rms(lp - lr) / _rms(lr)),
            "class_gap": float((up.amax(0) - served).max()) / scale}


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of the gap over the RMS of ``want`` (inf for another shape)."""
    if got.shape != want.shape:
        return float("inf")
    return float(_rms(got.float() - want) / _rms(want))


def leaf_gap(got: Dict[str, float], want: Dict[str, float], over=max,
             keep=None) -> float:
    """Per leaf, |got - want| over max(want, the median leaf's want); the
    worst leaf (``over=max``) or the median one."""
    med = statistics.median(want.values())
    names = [n for n in want if keep is None or keep(n)]
    return over([abs(got[n] - want[n]) / max(want[n], med, 1e-30)
                 for n in names])


def p98(values: List[float]) -> float:
    """The 98th percentile (``statistics.quantiles``, inclusive method)."""
    return statistics.quantiles(values, n=50, method="inclusive")[-1]


def train_steps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (each step's total),
    ``stage2`` and ``logits`` (``FirstOutputs``), ``grad_norms`` (name ->
    first clipped gradient's norm) and ``change_norms`` (name -> norm of
    the change after the steps)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    grads = ref["grad_norms"]
    floor = 1e-3 * statistics.median(grads.values())
    kept = [n for n in grads if grads[n] >= floor]
    change = ref["change_norms"]
    return {"stage2_gap": _rel(prog["stage2"], ref["stage2"]),
            "logit1_gap": _rel(prog["logits"], ref["logits"]),
            "loss_gap": loss_gap,
            "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
            / max(abs(ref["losses"][0]), 1e-30),
            "grad_gap": leaf_gap(prog["grad_norms"], grads),
            "grad_median": leaf_gap(prog["grad_norms"], grads,
                                    statistics.median),
            "change_gap": leaf_gap(prog["change_norms"], change,
                                   keep=lambda n: grads[n] >= floor),
            "change_median": leaf_gap(prog["change_norms"], change,
                                      statistics.median,
                                      keep=lambda n: grads[n] >= floor),
            "change_p98": leaf_gap(prog["change_norms"], change, p98,
                                   keep=lambda n: grads[n] >= floor)}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """Each number beside its limit."""
    return {k: {"value": float(readings[k]), "limit": float(limits[k])}
            for k in limits}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def leaf_norms(named: List, scale: float = 1.0) -> Dict[str, float]:
    """name -> float(norm of tensor x ``scale``), computed on the device in
    one stack and read back once."""
    norms = torch.stack([torch.linalg.vector_norm(t.float())
                         for _, t in named]) * scale
    return dict(zip([n for n, _ in named], norms.tolist()))


def change_norms(named: List, start: Dict[str, torch.Tensor]):
    """name -> norm of the parameter's change from ``start``."""
    return leaf_norms([(n, p.detach() - start[n]) for n, p in named])
