"""The evaluation loop, port of ``pad_batch`` and ``run_evaluation`` of
``stereoscene_tpu/engine/loop.py`` (ref: occupancy/apis/test.py:66-139).
The training loop is not ported yet."""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import metrics as ssc_metrics


def pad_batch(batch: Dict, batch_size: int) -> Dict:
    """Pad a short tail batch up to ``batch_size`` by repeating the last
    sample, with the padded ``gt_occ`` voxels set to the ignore label 255 so
    the metric state is unaffected; every batch of a run then has one
    shape."""
    n = next(iter(batch.values())).shape[0]
    if n == batch_size:
        return batch
    pad = batch_size - n
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        filler = np.repeat(v[-1:], pad, axis=0)
        if k == "gt_occ":
            filler = np.full_like(filler, 255)
        out[k] = np.concatenate([v, filler], axis=0)
    return out


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader's numpy batch as torch tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def run_evaluation(
    model,
    eval_step: Callable,
    eval_loader,
    *,
    use_kernel=None,
    class_names=ssc_metrics.KITTI_CLASS_NAMES,
    progress: bool = True,
) -> Dict[str, float]:
    """Streaming evaluation of ``model`` over ``eval_loader`` on the model's
    device; returns the reference-format metric dict (``semkitti_*`` keys
    and the combined sort key) with ``eval_time_s`` (wall seconds, loading
    included) and ``eval_frames``. Prints the running completion IoU and
    mIoU every 20 batches."""
    device = next(model.parameters()).device
    state = ssc_metrics.empty_state(device=device)
    t0 = time.time()
    n = 0
    batch_size = getattr(eval_loader, "batch_size", None)
    for i, batch in enumerate(eval_loader):
        n += int(np.asarray(next(iter(batch.values()))).shape[0])
        if batch_size is not None:
            batch = pad_batch(batch, batch_size)
        _, state = eval_step(model, to_device(batch, device), state,
                             use_kernel=use_kernel)
        if progress and i % 20 == 0:
            scores = ssc_metrics.compute(state)
            print(f"[eval] {n} frames, running SC IoU "
                  f"{float(scores['iou']):.4f}, mIoU "
                  f"{float(scores['iou_ssc_mean']):.4f}", flush=True)
    out = ssc_metrics.evaluate_dict(state, class_names)
    out["eval_time_s"] = time.time() - t0
    out["eval_frames"] = n
    return out
