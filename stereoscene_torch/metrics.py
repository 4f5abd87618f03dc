"""SSC (semantic scene completion) metrics, port of
``stereoscene_tpu/metrics.py`` (ref: projects/mmdet3d_plugin/utils/
ssc_metric.py:14-169).

The state is a small dict of per-class tp/fp/fn and the binary completion
counts. ``update_state`` builds the full confusion matrix of a batch with one
``torch.bincount`` over ``target * C + pred`` on the prediction's device.

Semantics as the JAX package's:
- voxels whose target is 255 are ignored (masked out, which is numerically
  the reference's zeroing of pred and target there for every reported
  number);
- completion: occupied = label > 0 for both pred and target;
- ``compute``: precision / recall / IoU for completion; per-class IoU with
  a +1e-5 denominator; mIoU over classes 1..C-1 (ssc_metric.py:87-102).

Counts are int64, exact at any eval size. The JAX package keeps float32
counts, which are exact only below 2**24 per entry.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import torch

from . import parallel

NUM_CLASSES = 20

# ref: semkitti.py:33-54 (stereoscene_tpu/losses/semkitti.py KITTI_CLASS_NAMES)
KITTI_CLASS_NAMES = [
    "empty", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]


def empty_state(num_classes: int = NUM_CLASSES,
                device=None) -> Dict[str, torch.Tensor]:
    """Fresh metric state of int64 counts on ``device`` (the CPU when
    None)."""
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int64,  # noqa: E731
                                       device=device)
    return {
        "tps": zeros(num_classes),
        "fps": zeros(num_classes),
        "fns": zeros(num_classes),
        "completion_tp": zeros(),
        "completion_fp": zeros(),
        "completion_fn": zeros(),
    }


def update_state(
    state: Dict[str, torch.Tensor],
    pred: torch.Tensor,
    target: torch.Tensor,
    num_classes: int = NUM_CLASSES,
) -> Dict[str, torch.Tensor]:
    """Accumulate one batch: ``pred`` [...] class ids (argmax applied),
    ``target`` [...] labels with 255 = ignore, on one device. Returns a new
    state on that device."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).to(pred.device).long()
    valid = target != 255

    # binary completion counts (ref ssc_metric.py:104-135)
    p_occ = (pred > 0) & valid
    t_occ = (target > 0) & valid
    comp_tp = (p_occ & t_occ).sum()
    comp_fp = (p_occ & ~t_occ).sum()
    comp_fn = (~p_occ & t_occ).sum()

    # the full confusion matrix in one bincount (ref loops :161-167)
    flat = torch.where(valid, target * num_classes + pred,
                       num_classes * num_classes)
    hist = torch.bincount(flat, minlength=num_classes * num_classes + 1)
    cm = hist[:num_classes * num_classes].reshape(num_classes, num_classes)
    tp = cm.diagonal()
    fp = cm.sum(0) - tp  # predicted j, true != j
    fn = cm.sum(1) - tp  # true j, predicted != j

    dev = pred.device
    return {
        "tps": state["tps"].to(dev) + tp,
        "fps": state["fps"].to(dev) + fp,
        "fns": state["fns"].to(dev) + fn,
        "completion_tp": state["completion_tp"].to(dev) + comp_tp,
        "completion_fp": state["completion_fp"].to(dev) + comp_fp,
        "completion_fn": state["completion_fn"].to(dev) + comp_fn,
    }


def reduce_state_host(states: Iterable[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The sum of per-shard metric states, on the CPU (replaces the
    reference's pickle-to-tmpdir rank gather, ref occupancy/apis/
    test.py:226-273)."""
    states = [{k: v.cpu() for k, v in s.items()} for s in states]
    return {k: sum((s[k] for s in states[1:]), start=states[0][k])
            for k in states[0]}


def all_processes_state(state: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """The metric state summed over every rank of the process group, on
    every rank, so each scores the same numbers and makes the same
    best-checkpoint choice (``stereoscene_tpu/metrics.py:101-115``); the
    state itself without a group. The counts are int64, so the sum is
    exact: W ranks over their shards equal one process over all frames."""
    return dict(zip(state, parallel.sum_tensors(list(state.values()))))


def compute(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Final scores in float64 (ref: ssc_metric.py:87-102)."""
    s = {k: v.double() for k, v in state.items()}
    tp, fp, fn = s["completion_tp"], s["completion_fp"], s["completion_fn"]
    iou_ssc = s["tps"] / (s["tps"] + s["fps"] + s["fns"] + 1e-5)
    return {
        "precision": tp / (tp + fp),
        "recall": tp / (tp + fn),
        "iou": tp / (tp + fp + fn),
        "iou_ssc": iou_ssc,
        "iou_ssc_mean": iou_ssc[1:].mean(),
    }


def evaluate_dict(state: Dict[str, torch.Tensor],
                  class_names: Sequence[str] = KITTI_CLASS_NAMES
                  ) -> Dict[str, float]:
    """Flat percentage dict with the reference's key names and the
    composite sort key (ref: datasets/semantic_kitti_lss_dataset.py:
    231-287)."""
    scores = {k: v.cpu() for k, v in compute(state).items()}
    res = {
        "SC_Precision": float(scores["precision"]),
        "SC_Recall": float(scores["recall"]),
        "SC_IoU": float(scores["iou"]),
        "SSC_mIoU": float(scores["iou_ssc_mean"]),
    }
    for name, val in zip(class_names, scores["iou_ssc"].tolist()):
        res[f"SSC_{name}_IoU"] = float(val)
    out = {f"semkitti_{k}": round(v * 100, 2) for k, v in res.items()}
    out["semkitti_combined_IoU"] = (out["semkitti_SC_IoU"]
                                    + out["semkitti_SSC_mIoU"])
    return out
