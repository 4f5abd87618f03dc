"""The numbers that decide ``correct``, each against its limit.

Serving: the numbers of the cell's family (``families/<family>.py``
``SERVE_NUMBERS``, ``serve_frame``), per sampled frame, the worst over
the sample.

Training (the first ``check_steps`` steps, which set-up drives through the
window's own step and feed):

- ``<name>_gap``: for each output the family names in
  ``FIRST_OUTPUTS``, the root-mean-square gap of the first step's output
  over the reference's root mean square;
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
  its limit);
- the family's ``STAGE_NUMBERS``, where it has them: stages of the first
  step judged alone (``training.reference_steps``).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Tuple

import torch

# every number a training comparison reads beside the first outputs'
# (``train_numbers``); the cell's limits name those that decide ``correct``
TRAIN_NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "grad_median",
                 "change_gap", "change_median", "change_p98")


def train_numbers(family) -> Tuple[str, ...]:
    """Every number a training cell of ``family`` reads."""
    return (tuple(k + "_gap" for k in family.FIRST_OUTPUTS) + TRAIN_NUMBERS
            + getattr(family, "STAGE_NUMBERS", ()))


class FirstOutputs:
    """Forward hooks that keep the first output of each module of
    ``paths`` (name -> module path; a checkpointed block's recompute comes
    later)."""

    def __init__(self, model, paths: Dict[str, str]):
        self.out: Dict[str, torch.Tensor] = {}
        self.handles = []
        for key, path in paths.items():
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


def rms(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean().sqrt()


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of the gap over the RMS of ``want`` (inf for another shape)."""
    if got.shape != want.shape:
        return float("inf")
    return float(rms(got.float() - want) / rms(want))


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


def train_steps(prog: Dict, ref: Dict,
                first: Iterable[str]) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (each step's total), the
    outputs named in ``first`` (``FirstOutputs``), ``grad_norms`` (name ->
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
    return {**{k + "_gap": _rel(prog[k], ref[k]) for k in first},
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
