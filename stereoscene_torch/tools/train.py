"""Training CLI, port of ``tools/train.py`` (ref: tools/train.py, the mmcv
runner launch).

Loads a python config (the reference's stereoscene.py schema), builds the
SemanticKITTI train loader with LiDAR depth (``gt_depth`` for the BCE depth
loss), the model from a seed, AdamW with the config's clip, step
milestones and frozen EfficientNet stages, and runs ``run_training``: eval
every ``evaluation.interval`` epochs, the last two checkpoints and the best
under ``WORK_DIR/ckpts``, a save on SIGTERM, and a resume from
``WORK_DIR/ckpts`` mid-epoch.

    python -m stereoscene_torch.tools.train CONFIG --work-dir W \\
        [--cfg-options key.path=value ...] [--seed 0] [--bf16] \\
        [--max-epochs N] [--batch-size B] [--save-interval-steps N] \\
        [--deterministic-data] [--profile] [--trace-dir DIR] [--device cuda] \\
        [--coordinator HOST:PORT --num-processes W --process-id I]

Training runs on the card unless ``--device cpu``. ``--resume-from`` is
parsed and, as in the JAX CLI, not read.

Data parallel (the JAX CLI's flags and meanings): W processes started with
the same ``--coordinator`` and ``--num-processes W``, each with its
``--process-id I``, join a process group (NCCL on ``cuda``, one card a
rank, ``cuda:I % cards``; gloo on ``cpu``). Rank I trains on its shard of
the index, ``frames[I::W]``, at ``--batch-size`` (by default the config's
``samples_per_gpu``) per rank, so the global batch is W times that; the
step computes the global batch's losses, BatchNorm statistics, masks and
gradient (``parallel``), and rank 0 writes the log and the checkpoints.
The JAX CLI's ``--spatial-shards`` (the voxel grid sharded over a
``space`` axis, whose halo exchanges GSPMD writes there) is not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from .. import parallel
from ..config import Config, merge_from_options
from ..data import (
    BatchLoader,
    PipelineConfig,
    SemanticKittiIndex,
    SemanticKittiPipeline,
)
from ..engine.eval import make_eval_step
from ..engine.loop import run_evaluation, run_training
from ..engine.train import (
    LossConfig,
    create_train_state,
    efficientnet_frozen_predicate,
    make_train_step,
)
from ..models.detector import BEVDepthOccupancy, DetectorConfig


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Train a stereoscene_torch model")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None,
                   help="deep config overrides, key.path=value "
                        "(mmcv DictAction semantics, ref tools/train.py:69-78)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None,
                   help="parsed and not read, as in the JAX CLI; a run "
                        "resumes from WORK_DIR/ckpts")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic-data", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="log each logged step's wall time between device "
                        "synchronisations")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 forward/backward with fp32 master params "
                        "(the reference's fp16 path)")
    p.add_argument("--save-interval-steps", type=int, default=0,
                   help="background checkpoint every N steps (preemption "
                        "safety; 0 = epoch-end only)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler chrome trace of steps 10-15")
    p.add_argument("--max-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (data-parallel "
                        "training over --num-processes processes)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, hooks=None):
    """Run the CLI; returns the final train state. ``hooks`` go to
    ``run_training``: callables ``(state, epoch, it, logs)`` run after every
    train step. With ``--coordinator`` the process joins the group for the
    run and leaves it at the end."""
    args = parse_args(argv)
    if args.coordinator is None:
        return _train(args, torch.device(args.device), hooks)
    device = parallel.init_distributed(args.coordinator, args.num_processes,
                                       args.process_id, args.device)
    try:
        return _train(args, device, hooks)
    finally:
        parallel.shutdown()


def _train(args: argparse.Namespace, device: torch.device, hooks):
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        merge_from_options(cfg, args.cfg_options)
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)

    det_cfg = DetectorConfig.from_config(cfg)
    occ_size = tuple(cfg["occ_size"])
    torch.manual_seed(args.seed)
    model = BEVDepthOccupancy(det_cfg, device=device, label_shape=occ_size)

    data_cfg = cfg["data"]
    dcfg = cfg["data_config"]
    pipe_cfg = PipelineConfig(
        input_size=tuple(dcfg["input_size"]),
        resize=tuple(dcfg["resize"]),
        rot=tuple(dcfg["rot"]),
        flip=dcfg["flip"],
        crop_h=tuple(dcfg["crop_h"]),
        resize_test=dcfg.get("resize_test", 0.0),
        is_train=True,
        load_lidar_depth=True,
        point_cloud_range=tuple(cfg["point_cloud_range"]),
    )
    train_index = SemanticKittiIndex(
        data_root=data_cfg["train"]["data_root"],
        ann_file=data_cfg["train"]["ann_file"],
        split="train",
        lidar_root=cfg.get("lidar_root"),
        lidarseg_root=cfg.get("lidarseg_root"),
    )
    if len(train_index) == 0:
        raise SystemExit(
            f"no training frames found under {data_cfg['train']['data_root']}"
            " — run python -m stereoscene_torch.tools.preprocess_kitti first")
    batch_size = args.batch_size or data_cfg["samples_per_gpu"]
    train_loader = BatchLoader(
        train_index.shard(parallel.rank(), parallel.world_size()),
        SemanticKittiPipeline(pipe_cfg, seed=args.seed),
        batch_size=batch_size,
        shuffle=not args.deterministic_data,
        seed=args.seed,
        num_workers=data_cfg.get("workers_per_gpu", 4),
    )

    opt_cfg = cfg["optimizer"]
    frozen_stages = cfg["model"]["img_backbone"].get("frozen_stages", 0)
    state = create_train_state(
        model,
        lr=opt_cfg["lr"],
        weight_decay=opt_cfg["weight_decay"],
        grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"],
        steps_per_epoch=parallel.reduce_ints([len(train_loader)], "min")[0],
        milestones=tuple(cfg["lr_config"]["step"]),
        frozen_predicate=(
            efficientnet_frozen_predicate(frozen_stages)
            if frozen_stages and frozen_stages > 0 else None),
        device=device,
    )

    loss_w = cfg["model"]["pts_bbox_head"]["semkitti_loss_weight_cfg"]
    loss_cfg = LossConfig(
        voxel_ce=loss_w.get("voxel_ce", 1.0),
        voxel_sem_scal=loss_w.get("voxel_sem_scal", 1.0),
        voxel_geo_scal=loss_w.get("voxel_geo_scal", 1.0),
        voxel_ohem=loss_w.get("voxel_ohem", 0.0),
        voxel_lovasz=loss_w.get("voxel_lovasz", 0.0),
        stream_voxel_chunks=loss_w.get("stream_voxel_chunks", 0),
        loss_depth_weight=cfg["model"]["img_view_transformer"].get(
            "loss_depth_weight", 1.0),
        downsample=det_cfg.downsample,
        dbound=det_cfg.dbound,
    )
    train_step = make_train_step(loss_cfg, bf16=args.bf16)

    def eval_fn(state):
        """The aug-free val split in fp32 with the model in eval mode, so
        each batch goes through the static splat plan of its calibration;
        each rank scores its shard (``run_evaluation`` sums the metric
        states)."""
        eval_pipe = PipelineConfig(
            input_size=pipe_cfg.input_size, is_train=False,
            point_cloud_range=pipe_cfg.point_cloud_range)
        eval_index = SemanticKittiIndex(
            data_root=data_cfg["val"]["data_root"],
            ann_file=data_cfg["val"]["ann_file"],
            split="val")
        eval_loader = BatchLoader(
            eval_index.shard(parallel.rank(), parallel.world_size()),
            SemanticKittiPipeline(eval_pipe),
            batch_size=max(1, batch_size // 2), shuffle=False,
            drop_last=False)
        return run_evaluation(state.model, make_eval_step(occ_size),
                              eval_loader)

    return run_training(
        model,
        state,
        train_step,
        train_loader,
        eval_fn=eval_fn,
        max_epochs=args.max_epochs or cfg["runner"]["max_epochs"],
        eval_interval=cfg["evaluation"]["interval"],
        work_dir=work_dir,
        seed=args.seed,
        profile=args.profile,
        trace_dir=args.trace_dir,
        save_interval_steps=args.save_interval_steps,
        hooks=hooks,
    )


if __name__ == "__main__":
    main()
