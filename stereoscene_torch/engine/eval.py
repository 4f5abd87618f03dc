"""Evaluation step: inference + streaming SSC metric state, port of
``stereoscene_tpu/engine/eval.py`` (ref: occupancy/apis/test.py:66-273).

The prediction follows ``simple_test`` (ref: bevdepth_occupancy.py:275-297):
the head's logits in fp32, upsampled trilinearly (align_corners=False) to
the ground truth's grid, then argmax, then the metric update. On a sharded
grid (``parallel.spatial``) the model gathers the logits on every space
rank, and only the first space rank of each sample updates the metric
state, so each frame is scored once when the states are summed over the
ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .. import metrics as ssc_metrics
from .. import parallel
from ..ops.resize import resize_trilinear


def make_eval_step(gt_shape: Tuple[int, int, int] = (256, 256, 32)
                   ) -> Callable:
    """Returns ``eval_step(model, batch, state, use_kernel=None) -> (pred,
    state)``. ``batch`` is the model's batch dict on its device, with
    ``gt_occ`` [B, X, Y, Z] when it has labels; ``pred`` is [B, X, Y, Z]
    int64 class ids on the grid of ``gt_occ``, else of ``gt_shape``;
    ``use_kernel`` goes to the model (None: the kernels on CUDA). The model
    is put in eval mode, the JAX step's ``train=False``."""

    @torch.no_grad()
    def eval_step(model, batch: Dict[str, torch.Tensor],
                  state: Dict[str, torch.Tensor], use_kernel=None):
        model.eval()
        logits = model(batch, use_kernel=use_kernel)["output_voxels"].float()
        target = (tuple(batch["gt_occ"].shape[1:4]) if "gt_occ" in batch
                  else tuple(gt_shape))
        if tuple(logits.shape[1:4]) != target:
            logits = resize_trilinear(logits, target)
        pred = logits.argmax(-1)
        if "gt_occ" in batch and parallel.space_rank() == 0:
            state = ssc_metrics.update_state(state, pred, batch["gt_occ"])
        return pred, state

    return eval_step
