"""Evaluation / submission CLI, port of ``tools/test.py``
(ref: tools/test.py + occupancy/apis/test.py:66-139).

Runs inference over the chosen split, streams the SSC metrics and prints
them, or, with ``--submission-dir`` / ``--save-pred-dir``, writes each
frame's prediction: SemanticKITTI benchmark ``.label`` files (argmax ->
``inv_map``, uint16) and / or the class grid as uint8 ``.npy``.

    python -m stereoscene_torch.tools.test CONFIG --checkpoint ckpt.pth \\
        [--split val] [--batch-size 1] [--device cuda] \\
        [--cfg-options key.path=value ...] \\
        [--submission-dir DIR] [--save-pred-dir DIR] [--flops] \\
        [--coordinator HOST:PORT --num-processes W --process-id I]

``--checkpoint`` takes a checkpoint in the reference's key layout (the
``state_dict`` entry of a training checkpoint, or the bare dict) and loads
it strictly, or the train CLI's ``WORK_DIR/ckpts`` directory, whose latest
step it loads; without one the weights are the model's seeded initial
ones.
Eval runs in fp32, on the card unless ``--device cpu``.

``--flops`` prints the parameter count and the aten FLOPs of one eval
forward on the plain route (``engine.flops``) before the run.

Multi-process eval (the JAX CLI's flags): W processes started with the
same ``--coordinator`` and ``--num-processes W``, each with its
``--process-id``, join a process group (NCCL on ``cuda``, one card a rank,
``cuda:I % cards``; gloo on ``cpu``). Each scores its shard of the index,
``frames[I::W]``, and writes the predictions of its own frames; the int64
metric states are summed over the ranks, so every rank prints the metrics
of all frames.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import parallel
from ..config import Config, merge_from_options
from ..data import (
    BatchLoader,
    PipelineConfig,
    SemanticKittiIndex,
    SemanticKittiPipeline,
    inv_map,
)
from ..data.semantic_kitti import FrameInfo
from ..engine import flops
from ..engine.checkpoint import CheckpointManager
from ..engine.eval import make_eval_step
from ..engine.loop import pad_batch, run_evaluation, to_device
from ..metrics import empty_state
from ..models.detector import BEVDepthOccupancy, DetectorConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Evaluate a stereoscene_torch model")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="deep config overrides, key.path=value "
                        "(mmcv DictAction semantics, ref tools/train.py:69-78)")
    p.add_argument("--checkpoint", default=None,
                   help="a .pth in the reference's key layout, or a train "
                        "run's ckpts directory (its latest step)")
    p.add_argument("--split", default="val",
                   choices=["val", "test", "test_submit"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--submission-dir", default=None,
                   help="write benchmark .label files here")
    p.add_argument("--save-pred-dir", default=None,
                   help="dump per-frame predicted voxel grids as .npy")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--flops", action="store_true",
                   help="print the parameter count and the aten FLOPs of "
                        "one eval forward on the plain route (the "
                        "reference's fvcore table, ref test.py:84)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (multi-process "
                        "eval; each process scores its index shard, the "
                        "metric states are summed over the processes)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def load_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference-layout checkpoint strictly (missing or unexpected
    keys raise)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    model.load_state_dict(ckpt, strict=True)


def write_prediction(pred: np.ndarray, frame: FrameInfo,
                     submission_dir: Optional[str] = None,
                     save_pred_dir: Optional[str] = None) -> None:
    """One frame's class grid [X, Y, Z] as
    ``submission_dir/sequences/<seq>/predictions/<id>.label`` (raw ids via
    ``inv_map``, uint16, the benchmark's format) and / or
    ``save_pred_dir/<seq>_<id>.npy`` (uint8 train ids)."""
    if save_pred_dir:
        os.makedirs(save_pred_dir, exist_ok=True)
        np.save(os.path.join(save_pred_dir,
                             f"{frame.sequence}_{frame.frame_id}.npy"),
                pred.astype(np.uint8))
    if submission_dir:
        out_dir = os.path.join(submission_dir, "sequences", frame.sequence,
                               "predictions")
        os.makedirs(out_dir, exist_ok=True)
        raw = inv_map()[pred.reshape(-1)].astype(np.uint16)
        raw.tofile(os.path.join(out_dir, frame.frame_id + ".label"))


def make_loader(cfg: Config, split: str, batch_size: int):
    """The config's SemanticKITTI frames of ``split`` through the eval
    pipeline, this rank's shard of them in a process group -> (frames,
    loader in frame order)."""
    data_cfg = cfg["data"]["val" if split == "val" else "test"]
    pipe_cfg = PipelineConfig(
        input_size=tuple(cfg["data_config"]["input_size"]),
        is_train=False,
        point_cloud_range=tuple(cfg["point_cloud_range"]),
    )
    index = SemanticKittiIndex(data_root=data_cfg["data_root"],
                               ann_file=data_cfg["ann_file"], split=split)
    if len(index) == 0:
        raise SystemExit(f"no frames for split {split}")
    frames = index.shard(parallel.rank(), parallel.world_size())
    loader = BatchLoader(frames, SemanticKittiPipeline(pipe_cfg),
                         batch_size=batch_size, shuffle=False,
                         drop_last=False, num_workers=4)
    return frames, loader


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI; returns the metric dict, or None after writing
    predictions. With ``--coordinator`` the process joins the group for the
    run and leaves it at the end."""
    args = parse_args(argv)
    if args.coordinator is None:
        return _evaluate(args, torch.device(args.device))
    device = parallel.init_distributed(args.coordinator, args.num_processes,
                                       args.process_id, args.device)
    try:
        return _evaluate(args, device)
    finally:
        parallel.shutdown()


def _evaluate(args: argparse.Namespace, device: torch.device):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        merge_from_options(cfg, args.cfg_options)
    det_cfg = DetectorConfig.from_config(cfg)
    occ_size = tuple(cfg["occ_size"])
    torch.manual_seed(0)
    model = BEVDepthOccupancy(det_cfg, device=device, label_shape=occ_size)
    if args.checkpoint and os.path.isdir(args.checkpoint):
        ckpts = CheckpointManager(args.checkpoint)
        step = ckpts.latest_step
        if step is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint}")
        load_checkpoint(model, ckpts.path(step))
        print(f"restored checkpoint step {step}")
    elif args.checkpoint:
        load_checkpoint(model, args.checkpoint)
        print(f"loaded checkpoint {args.checkpoint}")

    frames, loader = make_loader(cfg, args.split, args.batch_size)
    eval_step = make_eval_step(occ_size)

    if args.flops:  # the plan is made on the host, outside the count
        example = model.attach_plan(to_device(next(iter(loader)), device))
        flops.report(eval_step, model, model, example,
                     empty_state(device=device), use_kernel=False,
                     name="eval forward (incl. upsample+argmax)")

    if args.submission_dir or args.save_pred_dir:
        for i, batch in enumerate(loader):
            n_real = next(iter(batch.values())).shape[0]
            batch = to_device(pad_batch(batch, args.batch_size), device)
            pred, _ = eval_step(model, batch, empty_state(device=device))
            preds = pred[:n_real].cpu().numpy()
            for j, p in enumerate(preds):
                write_prediction(p, frames[i * args.batch_size + j],
                                 args.submission_dir, args.save_pred_dir)
        print("wrote predictions")
        return None

    results = run_evaluation(model, eval_step, loader)
    print("\nSemanticKITTI SSC Evaluation")
    for k, v in results.items():
        print(f"  {k}: {v}")
    return results


if __name__ == "__main__":
    main()
