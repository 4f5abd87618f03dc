"""Drive the PyTorch / CUDA port (``stereoscene_torch``) once on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure raises, so the script exits nonzero:

0. the card: ``torch.cuda.is_available()`` or raise; name and power limit
   as ``nvidia-smi`` reports them;
1. build the hand-written kernels of ``stereoscene_torch/csrc`` with nvcc,
   one process per source, all at once;
2. K1 (fused GWC + depth warp) against its plain PyTorch version at the
   flagship shapes, fp32 and bf16, plus boundary positions; then its
   autograd Function's gradients against plain autograd (fp32, 1e-5);
   its bf16 time as a share of its bound;
3. K3 (fused lift + splat) and K2 (sorted splat) against their plain
   versions on the real group-8 splat plan of the flagship calibration
   (1e-4 of max|ref|), two launches of each bitwise equal; the chunk
   size, the number of chunks, of voxels across chunks and of their
   partial sums, the longest voxel; K3 timed beside ``F.embedding_bag``
   over the same plan (held to the same tolerance), K2 beside
   ``index_add_``, each as a share of its bound; K3 with fp32 tables
   (eval's dtype: the kernels-line entry, as in earlier PRs) and bf16
   tables (serving's dtype; held to the plain version and to the kernel
   on their fp32 copies); K3's gathered feature bytes (L2 traffic) and
   their rate at the kernel's time, for each;
4. K4 (implicit-GEMM conv3d) against its plain version at the three
   flagship shapes, fp32 (1e-4 of max|ref|) and bf16 (2e-2 of max|ref|);
   per shape and per forward: bf16 kernel, plain and cuDNN ms, the bound,
   the kernel's share of it and its TFLOP/s;
4b. P1 (the DCN gather) at the flagship DepthNet DCN [1, 48, 160, 640],
   G = 4, with the Pallas probe's offsets (randn * 1.5), the seeded offset
   head's and serving's (the bf16 head output as a permuted NCHW view, read
   in place): the kernel against its plain version (fp32 1e-5, bf16 2e-2
   of max|ref|), two launches bitwise equal, the whole z-gather route
   against the plain gather DCN (fp32, 1e-5), and its autograd Function's
   gradients (x, offsets, weights) against plain autograd (fp32, 1e-5 of
   each gradient's max); timed beside ``F.embedding_bag`` on the corner
   tables (held to the same tolerances); its bare C entry's device time and
   share of the bound;
4c. P2 (the row gather) at the Pallas probe's shapes, feat [7680, 128], for
   the three index layouts [1024, 128], [1024, 1] and [1024]: bitwise
   equal to its plain version; its whole call timed beside
   ``torch.take_along_dim``'s, and its kernel's device time
   (torch.profiler);
5. the flagship forward (EfficientNet-b7, 384x1280, D = 112, the 64x64x8
   grid of 0.8 m voxels) in fp32 with and without the kernels, seeded
   random weights;
6. serving: the bf16 model answers three requests (different images, one
   calibration) through ``BEVDepthOccupancy.infer`` -> [256, 256, 32]
   class maps; per-stage and per-frame milliseconds;
7. training: one synthetic labelled batch from the seed; (a) one fp32 step
   built with the kernels (K1, P1, K4) and one without, losses within 1e-4
   and every gradient leaf within 2% of its scale (floor 1e-4 of the global
   scale); (b) six bf16 steps with the kernels: finite, falling losses, ms
   per step and peak memory;
8. eval: a full-size SemanticKITTI tree (four seeded val frames and four
   train frames: 376x1241 stereo PNGs, calib.txt, voxel labels
   [256, 256, 32] with ignore labels, a 120,000-point velodyne sweep and
   its lidarseg labels per frame) and a checkpoint of the seeded fp32
   flagship, written under TMPDIR; the
   eval CLI ``stereoscene_torch.tools.test.main`` on the card writes the
   ``.label`` / ``.npy`` predictions, then scores; the same checkpoint
   through ``engine.loop.run_evaluation`` without the kernels: predictions
   agree on at least 99.99% of voxels, every ``semkitti_*`` metric within
   0.01 points, each ``.label`` file is ``inv_map`` of its ``.npy``;
   frames per second and ``eval_time_s``, PNG decoding included;
9. training from data: the train CLI ``stereoscene_torch.tools.train.main``
   on the card with the flagship config (B = 2, bf16, two epochs of the
   four train frames in index order, the LiDAR depth branch on), then its
   eval after epoch 2 over the four val frames: the gt_depth pixels per
   eye and one frame's LiDAR products' host ms, every step's loss terms
   (all finite, the depth term nonzero), ms per step, the peak memory, the
   steps left in ``ckpts/``, the launches (K1, P1 and K3 at least once);
   then the eval CLI on ``ckpts/`` gives the loop's eval metrics within
   0.01 points;
10. data parallelism: two ranks spawned on the one card, joined over gloo
   (NCCL refuses two ranks on one device), each run the train CLI on the
   flagship config at B = 1 (a global batch of 2), bf16, index order, for
   one epoch (2 steps, then the loop's eval, two val frames a rank): the
   ranks' loss terms bitwise equal every step, a digest of every
   parameter's bits equal after every step, step 1 within 1e-3 relative of
   phase 9's B = 2 step 1, K1, P1 and K3 launched on each rank; then the
   two ranks' eval CLI on phase 9's ``ckpts/`` gives exactly its 25
   ``semkitti_*`` metrics; then one rank over NCCL (``--coordinator``)
   takes 2 finite steps; then ``--flops`` on the flagship eval forward.
   Prints ms per step and peak GiB per rank, the gradient all-reduce's ms
   per step and bytes, eval frames/s (two ranks time-slice one card: not a
   data-parallel speed-up).
11. the optional branches and the rest of the training recipe at the
   flagship widths, with the grid mask, the imgseg head, CRP3D (8x8x1
   mega-voxels on stage 2's 16x16x2 grid) and the point branch on and
   every loss term (OHEM, Lovasz, dice, LGA, the KL depth loss, imgseg,
   CRP, point CE and Lovasz): (a) the tree's train frames through an index
   built with CBGS (frame counts before and after) and the train pipeline
   with relation labels (16, 16, 2), four bf16 steps at B = 2 with
   ``with_cp`` and ``debug_grads``: every term present and finite,
   ``grad_nonfinite`` 0, nonzero gradients in CRP3D, the imgseg head and
   the point branch, K1 and P1 launched; ms per step and peak memory;
   (b) one fp32 step at B = 1 with the kernels (K1, P1, K4) and one
   without: every term within 1e-4 relative, every gradient leaf within
   2% (floor 1e-4 of the global scale); (c) the streaming loss triple (8
   Y-slabs) against the full upsample on flagship-shaped fp32 logits and
   the 256x256x32 labels, within 1e-5 relative, gradient included, with
   both peak memories; (d) the pipeline with BDA: a 4x4 ``bda``,
   ``gt_occ`` of its shape with a larger 255 share under a rotation, and
   the detector's refusal of the 33-wide camera vector; (e) the burn-in
   tool (``stereoscene_torch/tools/train_burnin.py``) passes its checks;
   (f) the train CLI with ``model.use_grid_mask=True`` and the OHEM and
   Lovasz terms takes 2 bf16 steps at B = 1 and logs both terms.
12. the BEVOcc family, ``bev_with_cp`` and the variant modules: (a)
   BEVOcc_kitti from ``stereoscene_torch/configs/bevocc_kitti.py`` (b0,
   a 64x64x8 coarsest level, two levels, embed 128) on the flagship left
   eye at 384x1280: its fp32 logits [1, 64, 64, 8, 20] and
   [1, 128, 128, 16, 20] against the port's CPU run on the same seeded
   weights within 1e-3 of max|ref| (TF32 off), the eval forward's median
   ms over 3 frames after a warm-up, then 4 fp32 AdamW steps at B = 1 on
   seeded 128x128x16 labels: finite ``loss_occ_i``, ms per step, peak
   memory; (b) the flagship with ``bev_with_cp``: an fp32 step at B = 1
   with it and without (every loss term within 1e-4 relative, the running
   statistics within 1e-4, every gradient leaf within 2%, floor 1e-4 of
   the global scale; K1 and P1 launch again in the recompute), then bf16
   steps at B = 2 with it and without: ms per step and the peak memory,
   lower with it; (c) ``DepthNetStereo`` at the reference widths (a
   512-wide mid on the 48x160 features of 640 channels) with P1 against
   its plain route (1e-4 of max|ref|), then the temporal shift, the
   ``DepthAggregation``, both 3D necks, the shared head, the voxel
   encoders, ViT, VoVNet and EfficientNet-es on the card against their CPU
   results (fp32, TF32 off, 1e-3 of max|ref|).
13. the nuScenes family, on no kernel (none lies on its path): (a) the
   BEVFormer detector at BEVFormer-tiny's widths (six cameras, embed 256,
   a 50x50 BEV, 3 encoder and 6 decoder layers, 900 queries, 10 classes,
   one seeded 15x25x256 feature level) with calibration from
   ``NuScenesPipeline`` over a synthetic mmdet3d info pickle of six
   seeded 900x1600 JPEGs at the nuScenes camera headings (host ms per
   sample): its fp32 outputs on two frames (the second with ``prev_bev``
   and can_bus) against the CPU within 1e-3 of max|ref| (TF32 off); the
   eval forward's median ms over three frames of one scene through
   ``PrevFrameInfo``, then a fourth frame of a new scene that resets it;
   4 fp32 AdamW steps at B = 1, each with a 2-frame history through
   ``obtain_history_bev`` and 30 seeded boxes: every loss term finite, ms
   per step, peak memory, the Hungarian matchings' host ms a step (the
   copy to the host and scipy); ``bevformer_get_bboxes`` and
   ``evaluate_detections``: mAP and NDS in [0, 1]; (b) the Mask2Former
   occupancy head at the JAX defaults: on 50x50x4 against the CPU within
   1e-3 of max|ref|, its attention masks equal, the resampled mask logits
   within 1e-5 of 0 counted; on the 200x200x16 nuScenes occupancy grid the
   fp32 forward's ms, ``semantic_inference`` [1, 200, 200, 16, 20] and 2
   AdamW steps on ``mask2former_loss_all_layers``: every term finite, ms
   per step, peak memory (a grid that does not fit fails the phase); (c)
   ``batched_nms`` on 900 seeded boxes and ``decode_nms_free`` on
   [1, 900, 10] equal to their CPU runs.
14. the high-resolution config (``stereoscene_torch/configs/
   stereoscene_highres.py``: a 256x256x32 grid, seeded 512x512x64 labels,
   the streaming losses over 16 Y-slabs) with ``bev_with_cp`` and K4 on
   seeded weights: (a) bf16 AdamW steps at B = 1 and, where twice B = 1's
   peak fits in 90% of the card, at B = 2: ms per step and peak; the fp32
   eval forward through ``infer`` -> [1, 512, 512, 64]; K3 on the highres
   plan against its plain version (1e-4 of max|ref|), timed beside
   ``F.embedding_bag``; K4 at ResNet3D level 0's [1, 128, 256, 256, 32]
   against its plain version (fp32 1e-4, bf16 2e-2 of max|ref|), timed
   beside cuDNN; (b) two ranks spawned on the one card over gloo, laid
   out as data 1 x space 2 (``parallel.init_space``), each on its X slab
   of 128 planes, one fp32 step (TF32 off) against one process on the
   same batch and weights: every loss term within 1e-4 relative, every
   gradient leaf within 2% (floor 1e-4 of the global scale), the ranks'
   parameter digests equal; ms per step, halo bytes sent and peak per
   rank.
15. the last slice: (a) the flagship with K4 at ResNet3D depths 34, 50
   and 101 (BasicBlock 34, Bottleneck 50 and 101): at each depth the fp32
   eval forward with the kernels against the same weights built without
   K4 and run on the plain route (phase 5's limits, TF32 off), its class
   map through ``infer`` (5 timed calls), K4's launches in the forward
   and, printed and not counted, in the 3D encoder alone (none fails the
   phase); at 50 an fp32 step with the kernels and one without (phase
   7a's limits); at 18, 50 and 101 bf16 B = 1 steps with ``bev_with_cp``
   (7 timed after the first): ms per step and peak; (b) the branches that
   read the whole grid on a sharded flagship grid: two gloo ranks at data
   1 x space 2 (X slabs of 32) with CRP3D (8x8x1), the point branch (a
   tree frame's LiDAR points) and the OHEM, dice and LGA terms beside ce,
   sem_scal, geo_scal, depth, the relation loss and point CE and Lovasz,
   one fp32 step (TF32 off) against one process (phase 14b's limits); ms
   per step, halo bytes sent and bytes gathered per rank; (c) one train
   frame's LiDAR products (a 120,000-point sweep) on the native host
   library and on the numpy route: host ms of each, the pixels where they
   differ (the native route must be the one taken); (d) the dataset CLIs
   on the tree: ``print_config``, ``debug_dataset`` (its route line),
   ``create_data semantickitti`` (scales 1_1 and 1_2 of one packed frame)
   and ``flops_table`` on the card (its total equals phase 10's eval
   ``--flops`` count).
16. K3 with bf16 tables at the highres slice's own plan (the quartered
   grid on the slice tool's frame) against its plain version, then the
   measurement tools, each as ``python -m
   stereoscene_torch.tools.<tool>`` in a process of its own, so that its
   numbers do not depend on the phases before it: ``bench_train`` at
   B = 1 (5 timed bf16 steps with backbone checkpointing) and at B = 2
   with ``--bev-cp``, ``highres_slice --shards 4`` (one card's quarter of
   the highres grid, [64, 256, 32]) forward in bf16 and with ``--train``
   (3 timed steps); each JSON line printed, with finite losses,
   ``step_ms`` > 0, 0 < ``mfu`` < 1 on the H100, the slice's grid and
   every peak under the card's memory; each tool's launches (K1 and P1,
   and K3 in the slice's forward), which it counts from its first step
   and prints on its stderr.

Then one JSON line with each kernel (its launches in the serving, bf16
training, eval, train CLI, data-parallel, optional-branch, phase 12b /
12c, phase 13, phase 14, phase 15 and phase 16 runs, each
counted from 0 just
before its run, its
error, its times and its bound from phases 2-4c; the
bound is the larger of the bytes it must move over 3.35 TB/s and its
operations over the H100 SXM datasheet's peak for their type, 989 TFLOP/s
bf16 dense, 67 TFLOP/s fp32) and, last, the ok line. Every time is
measured in this run on this card. No JAX is imported.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from stereoscene_torch.tools import _frames
from stereoscene_torch.tools._frames import BASELINE, FX

SEED = 0
N_REQUESTS = 3
N_TRAIN_STEPS = 6
N_EVAL_FRAMES = 4
N_TRAIN_FRAMES = 4  # sequence 00 of the phase 8-9 tree
N_LIDAR_POINTS = 120_000  # about one HDL-64 sweep
CLI_EPOCHS = 2  # the flagship config evaluates every 2 epochs
DP_TIMEOUT_S = 300.0  # phase 10's process group and spawned ranks
OPTIONAL_STEPS = 4  # phase 11a's bf16 steps at B = 2
LABEL_SHAPE = (256, 256, 32)
EVAL_CONFIG = "stereoscene_semantickitti.py"  # the flagship's config file
# H100 SXM datasheet peaks (dense, without sparsity)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# phase 13: BEVFormer-tiny's widths (BEVFormer
# projects/configs/bevformer/bevformer_tiny.py) on one feature level of
# 15x25x256 (ResNet-50's C5 of a 480x800 image), nuScenes' six cameras
BEVFORMER_TINY = dict(num_classes=10, num_query=900, embed_dim=256,
                      bev_shape=(50, 50), num_encoder_layers=3,
                      num_decoder_layers=6,
                      pc_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0))
NUSC_FEAT = (15, 25, 256)
NUSC_IMAGE = (900, 1600)
NUSC_INPUT = (480, 800)
NUSC_GT_BOXES = 30
# the detector's parameters that steer its deformable sampling and box
# refinement, which phase 13a scales by STEERING_SCALE after seeded_init_
STEERING = ("sampling_offsets.weight", "attention_weights.weight",
            "_out.weight")
STEERING_SCALE = 0.03
NUSC_HEADINGS = {"CAM_FRONT_LEFT": 55.0, "CAM_FRONT": 0.0,
                 "CAM_FRONT_RIGHT": -55.0, "CAM_BACK_LEFT": 110.0,
                 "CAM_BACK": 180.0, "CAM_BACK_RIGHT": -110.0}
# the JAX package's Mask2FormerOccHead defaults; the nuScenes occupancy
# grid (tests/test_nuscenes.py's gt_occ)
MASK2FORMER = dict(num_queries=50, embed_dim=64, num_layers=3,
                   num_classes=20, num_heads=8, num_feat_levels=2,
                   num_encoder_layers=2)
M2F_IN = 64
M2F_SMALL = (50, 50, 4)
NUSC_OCC = (200, 200, 16)
# the flagship's K4 convs: (Ci, D, H, W, Co) and launches per forward
K4_SHAPES = {"hourglass conv2": ((64, 56, 24, 80, 64), 4),
             "hourglass conv4": ((128, 28, 12, 40, 128), 4),
             "resnet3d stage 1": ((128, 64, 64, 8, 128), 4)}
# phase 14: the high-resolution config, its bf16 steps a batch size (the
# first left out of the times), its two-rank sharded step's deadline
HIGHRES_CONFIG = "stereoscene_highres.py"
HIGHRES_STEPS = 3
SP_TIMEOUT_S = 600.0
# phase 16: the measurement tools, each in a process of its own, and the
# kernels each run must launch
TOOL_RUNS = (
    ("bench_train", ("--batches", "1", "--iters", "5"),
     ("gwc_warp", "dcn_gather")),
    ("bench_train", ("--batches", "2", "--bev-cp", "--iters", "5"),
     ("gwc_warp", "dcn_gather")),
    ("highres_slice", ("--shards", "4"),
     ("gwc_warp", "dcn_gather", "lift_splat_fused")),
    ("highres_slice", ("--shards", "4", "--train", "--iters", "3"),
     ("gwc_warp", "dcn_gather")),
)
TOOL_TIMEOUT_S = 300.0
SLICE_GRID = [64, 256, 32]  # the highres grid's X cut to 1/4


def cuda_ms(fn, iters: int = 20, reps: int = 1) -> float:
    """Median device time of ``reps`` back-to-back calls of ``fn`` over
    ``iters`` CUDA-event runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, name: str, calls: int = 20):
    """Device ms per call of the kernels whose name holds ``name`` among
    those ``fn`` launches, by torch.profiler over ``calls`` calls after one
    warm-up: a kernel's own time where the call's host side outlasts it.
    None when the profiler records no device time for them."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", 0.0)
             for ev in prof.key_averages() if name in ev.key)
    return us / 1e3 / calls if us else None


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if got.shape != want.shape or not bool((err <= limit).all()):
        raise AssertionError(
            f"{name}: kernel disagrees with plain: shape {tuple(got.shape)} "
            f"vs {tuple(want.shape)}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def phase_gwc(cfg, dev, gwc) -> dict:
    """K1 at the flagship: match features [1, fH, fW, 64], G = 32, D = K."""
    from stereoscene_torch.geometry import disparity_positions

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fh, fw = cfg.feature_size
    d = cfg.num_depth
    left = torch.randn(1, fh, fw, 64, generator=gen, device=dev)
    right = torch.randn(1, fh, fw, 64, generator=gen, device=dev)
    pos = disparity_positions(torch.full((1,), FX * BASELINE, device=dev), d)

    def run(l, r, p, out_dtype, use_kernel):
        return gwc.fused_gwc_warp(l, r, p, d, 32, out_dtype=out_dtype,
                                  use_kernel=use_kernel)

    err32 = check_close("gwc fp32", run(left, right, pos, torch.float32, True),
                        run(left, right, pos, torch.float32, False),
                        1e-5, 1e-5)
    edge = torch.tensor([-1.5, -0.4, 0.0, 0.6, d - 1.0, float(d), 8.2],
                        device=dev)
    edge = torch.cat([edge, pos[0, :d - len(edge)]])[None]
    err_edge = check_close(
        "gwc boundary", run(left, right, edge, torch.float32, True),
        run(left, right, edge, torch.float32, False), 1e-5, 1e-5)
    lb, rb = left.bfloat16(), right.bfloat16()
    err16 = check_close("gwc bf16", run(lb, rb, pos, torch.bfloat16, True),
                        run(lb, rb, pos, torch.bfloat16, False), 2e-2, 2e-2)
    ms = cuda_ms(lambda: run(lb, rb, pos, torch.bfloat16, True))
    plain_ms = cuda_ms(lambda: run(lb, rb, pos, torch.bfloat16, False))
    ms32 = cuda_ms(lambda: run(left, right, pos, torch.float32, True))
    plain_ms32 = cuda_ms(lambda: run(left, right, pos, torch.float32, False))
    out = run(lb, rb, pos, torch.bfloat16, True)
    # two lerp taps of a C-channel product each, then the lerp
    ops = 2 * 2 * out.numel() * left.shape[-1] // 32 + 3 * out.numel()
    k1 = dict(max_abs_err=max(err32, err_edge), ms=ms, plain_ms=plain_ms,
              library_ms=None,
              **bound(nbytes(lb, rb, pos, out), ops, torch.bfloat16))
    print(f"phase 2 K1 gwc_warp [1, {d}, {fh}, {fw}, 32]: max abs err fp32 "
          f"{err32:.3e} boundary {err_edge:.3e} bf16 {err16:.3e}; median of "
          f"20: bf16 kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
          f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}; the kernel at "
          f"{k1['bound_ms'] / ms:.1%} of it), fp32 kernel "
          f"{ms32:.4f} ms plain {plain_ms32:.4f} ms", flush=True)

    g = torch.randn(out.shape, generator=gen, device=dev)
    ins = [t.clone().requires_grad_() for t in (left, right)]
    (run(*ins, pos, torch.float32, True) * g).sum().backward()
    ref = [t.clone().requires_grad_() for t in (left, right)]
    (gwc.gwc_warp_plain(*ref, pos, d, 32) * g).sum().backward()
    errs = [check_close(f"gwc backward d{name}", a.grad, b.grad, 1e-5, 1e-5)
            for name, a, b in zip(("left", "right"), ins, ref)]
    print(f"phase 2 K1 backward (autograd Function, fp32): max abs err "
          f"dleft {errs[0]:.3e} dright {errs[1]:.3e} vs plain autograd",
          flush=True)
    return k1


def splat_library(dp, feat, order, bounds, group):
    """K3's function as one PyTorch call: ``F.embedding_bag`` in sum mode,
    one bag per voxel (rows ``bounds[v] * group`` up to the next voxel's),
    each plan row weighted by its depth probability (0 for pad rows); the
    indices and weights are prepared outside the timed call. Timed, never
    used by the port."""
    p_total = dp.numel()
    od = order.long()
    odc = od.clamp(max=p_total - 1)
    idx = odc % feat.shape[0]
    weights = dp[odc] * (od < p_total)
    offsets = bounds.long() * group
    return lambda: torch.nn.functional.embedding_bag(
        idx, feat, offsets, mode="sum", per_sample_weights=weights,
        include_last_offset=True)


def chunk_partition(bounds, group: int, rows: int, chunk_rows: int) -> dict:
    """How csrc/splat.cu splits a plan: bounds [num_voxels + 1] (voxel v
    owns rows [bounds[v]*group, bounds[v+1]*group)), ``rows`` plan rows in
    chunks of ``chunk_rows``. Per voxel: its ``first`` and ``last`` chunk,
    ``direct`` (its chunk writes it), ``crossing`` (the fix-up adds its
    partials, the tail slot of ``first`` then the head slots of
    ``first + 1 .. last``) and ``empty`` (the fix-up writes zeros); and
    ``n_chunks``, ``n_partials`` and ``longest`` (rows of the longest
    voxel)."""
    b = np.asarray(bounds, np.int64) * group
    begin, end = b[:-1], b[1:]
    empty = end <= begin
    first = begin // chunk_rows
    last = np.where(empty, first, (end - 1) // chunk_rows)
    crossing = ~empty & (last > first)
    return dict(first=first, last=last, empty=empty,
                direct=~empty & ~crossing, crossing=crossing,
                n_chunks=-(-rows // chunk_rows), chunk_rows=chunk_rows,
                n_partials=int((last - first + 1)[crossing].sum()),
                longest=int((end - begin).max(initial=0)))


def splat_inputs(model, cpu_batch, dev) -> dict:
    """Phase 3's inputs: the flagship calibration's group-8 plan (``order``,
    ``bounds``) with seeded fp32 tables ``dp`` [D*fH*fW] and ``feat``
    [fH*fW, C] for K3; for K2 the lifted rows ``vals`` of the group-1 plan
    of the same points, their sorted ranks ``ranks1`` and bounds
    ``bounds1``. The plans depend on the geometry only, not on the
    weights."""
    from stereoscene_torch.ops import splat_plan

    cfg = model.cfg
    nvox = int(np.prod(cfg.grid_shape))
    planned = model.attach_plan(cpu_batch)
    points = model.compute_ranks(cpu_batch)[0].numpy()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    fh, fw = cfg.feature_size
    dp = torch.softmax(torch.randn(cfg.num_depth, fh * fw, generator=gen,
                                   device=dev), 0).reshape(-1)
    feat = torch.randn(fh * fw, cfg.numC_Trans, generator=gen, device=dev)
    order1, rs1 = splat_plan.build_plan(points, nvox, group=1)
    o1 = torch.from_numpy(order1).to(dev).long()
    ranks1 = torch.from_numpy(rs1).to(dev)
    vals = (dp[o1][:, None] * feat[o1 % (fh * fw)]
            * (ranks1 < nvox).float()[:, None])
    return dict(dp=dp, feat=feat, group=cfg.splat_group, nvox=nvox,
                order=planned["splat_order"][0].to(dev),
                bounds=planned["splat_bounds"][0].to(dev),
                ranks8=planned["splat_ranks"][0], points=points, vals=vals,
                ranks1=ranks1, bounds1=splat_plan.plan_bounds(rs1, nvox))


def phase_splat(model, cpu_batch, dev, pool):
    """K3 and K2 on the flagship calibration's real plans."""
    x = splat_inputs(model, cpu_batch, dev)
    dp, feat, order, bounds = x["dp"], x["feat"], x["order"], x["bounds"]
    group, nvox, c = x["group"], x["nvox"], feat.shape[1]
    points = x["points"]

    def fused(use_kernel, tables=(dp, feat)):
        return pool.lift_splat_fused(*tables, order, bounds, group, nvox,
                                     use_kernel=use_kernel)

    want = fused(False)
    scale = float(want.abs().max())
    got = fused(True)
    err3 = check_close("splat fused", got, want, 1e-4 * scale, 0.0)
    if not torch.equal(got, fused(True)):
        raise AssertionError("splat fused: two launches differ")
    library = splat_library(dp, feat, order, bounds, group)
    err3_lib = check_close("splat fused embedding_bag", library(), want,
                           1e-4 * scale, 0.0)
    # serving's dtype: bf16 tables, widened exactly in the kernel
    t16 = (dp.bfloat16(), feat.bfloat16())
    got16 = fused(True, t16)
    want16 = fused(False, t16)
    err3_16 = check_close("splat fused bf16", got16, want16,
                          1e-4 * float(want16.abs().max()), 0.0)
    if not torch.equal(got16, fused(True, t16)):
        raise AssertionError("splat fused bf16: two launches differ")
    # the same sums over their fp32 copies, in another order
    err3_16c = check_close("splat fused bf16 vs fp32 copies", got16,
                           fused(True, tuple(t.float() for t in t16)),
                           1e-4 * float(want16.abs().max()), 0.0)
    # fp32 tables (eval's dtype) make the kernels-line entry, as in
    # earlier PRs; bf16 tables are timed beside them
    ms3, plain3 = cuda_ms(lambda: fused(True)), cuda_ms(lambda: fused(False))
    ms3_16 = cuda_ms(lambda: fused(True, t16))
    lib3 = cuda_ms(library)

    vals, ranks1 = x["vals"], x["ranks1"]

    def sorted_(use_kernel):
        return pool.splat_sorted(vals, ranks1, nvox, use_kernel=use_kernel)

    want2 = sorted_(False)
    got2 = sorted_(True)
    err2 = check_close("splat sorted", got2, want2,
                       1e-4 * float(want2.abs().max()), 0.0)
    if not torch.equal(got2, sorted_(True)):
        raise AssertionError("splat sorted: two launches differ")
    ms2, plain2 = cuda_ms(lambda: sorted_(True)), cuda_ms(
        lambda: sorted_(False))
    overflow = ranks1.long().clamp(max=nvox)  # pad rows -> a dropped bucket
    acc = torch.zeros(nvox + 1, c, device=dev)
    lib2 = cuda_ms(lambda: acc.index_add_(0, overflow, vals))
    rows8 = int((x["ranks8"] < nvox).sum())
    part3 = chunk_partition(x["bounds"].cpu().numpy(), group, len(order),
                            pool.CHUNK_ROWS)
    part2 = chunk_partition(x["bounds1"], 1, len(ranks1), pool.CHUNK_ROWS)
    # K3's live rows: each gathers a feature row from the L2-resident
    # table and takes C multiply-adds
    live = int((order < dp.numel()).sum())
    gathered, gathered16 = live * nbytes(feat[0]), live * nbytes(t16[1][0])
    k3 = dict(max_abs_err=err3, ms=ms3, plain_ms=plain3, library_ms=lib3,
              **bound(nbytes(dp, feat, order, bounds, want), 2 * live * c,
                      torch.float32))
    k2 = dict(max_abs_err=err2, ms=ms2, plain_ms=plain2, library_ms=lib2,
              **bound(nbytes(vals, ranks1, want2), vals.numel(),
                      torch.float32))

    def chunks(part):
        return (f"chunks of {part['chunk_rows']} rows: {part['n_chunks']}, "
                f"{int(part['crossing'].sum())} voxels across chunks with "
                f"{part['n_partials']} partials, {int(part['empty'].sum())} "
                f"empty, longest voxel {part['longest']} rows")

    print(f"phase 3 K3 lift_splat_fused: group-{group} plan of "
          f"{len(order)} rows ({rows8} in voxels = {rows8 // group} groups, "
          f"{int((points < nvox).sum())} in-bounds points) -> [{nvox}, {c}]; "
          f"{chunks(part3)}; max abs err {err3:.3e} (max|ref| {scale:.3e}; "
          f"embedding_bag {err3_lib:.3e}); two launches bitwise equal; "
          f"median of 20, fp32 tables: kernel {ms3:.4f} ms plain "
          f"{plain3:.4f} ms embedding_bag {lib3:.4f} ms bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']}, the kernel at "
          f"{k3['bound_ms'] / ms3:.1%} of it); L2 gather {gathered / 1e6:.1f} "
          f"MB of feature rows from a {nbytes(feat) / 1e6:.2f} MB table, "
          f"{gathered / ms3 / 1e9:.2f} TB/s at the kernel's time; bf16 "
          f"tables (serving's dtype): max abs err {err3_16:.3e} (vs the "
          f"kernel on their fp32 copies {err3_16c:.3e}), bitwise equal "
          f"twice, kernel {ms3_16:.4f} ms, L2 gather {gathered16 / 1e6:.1f} "
          f"MB, {gathered16 / ms3_16 / 1e9:.2f} TB/s | K2 splat_sorted: "
          f"group-1 plan of {len(ranks1)} rows; {chunks(part2)}; max abs err "
          f"{err2:.3e}; two launches bitwise equal; kernel {ms2:.4f} ms "
          f"plain {plain2:.4f} ms index_add_ {lib2:.4f} ms bound "
          f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}, the kernel at "
          f"{k2['bound_ms'] / ms2:.1%} of it)", flush=True)
    return k3, k2


def phase_conv3d(dev, conv3d) -> dict:
    """K4 at the flagship's three conv shapes, fp32 and bf16; times in
    bf16 (the training step's dtype) for the kernel on a channels-last
    input, its plain version and cuDNN's ``F.conv3d`` on channels-last
    tensors, each shape's four launches of a forward timed back to back.
    The kernels-line entry sums the 12 launches of a forward."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    worst, parts, moved, ops = 0.0, [], 0, 0
    torch.backends.cudnn.allow_tf32 = False
    for name, ((ci, d, h, w, co), count) in K4_SHAPES.items():
        x = torch.randn(1, ci, d, h, w, generator=gen, device=dev)
        wt = torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev)
        wt = wt * ci ** -0.5
        errs = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xd, wd = x.to(dtype), wt.to(dtype)
            want = conv3d.conv3d_s1_plain(xd, wd)
            got = conv3d.conv3d_s1(xd, wd, use_kernel=True)
            errs[dtype] = check_close(
                f"conv3d {name} {dtype}", got, want,
                tol * float(want.float().abs().max()), 0.0)
        xp, wb = x.bfloat16(), wt.bfloat16()
        xb = xp.contiguous(memory_format=torch.channels_last_3d)
        wcl = wb.contiguous(memory_format=torch.channels_last_3d)
        # a forward's `count` launches of the shape back to back, per launch
        ms = cuda_ms(lambda: conv3d.conv3d_s1(xb, wb, use_kernel=True),
                     reps=count) / count
        plain = cuda_ms(lambda: conv3d.conv3d_s1_plain(xp, wb),
                        reps=count) / count
        lib = cuda_ms(lambda: torch.nn.functional.conv3d(xb, wcl, padding=1),
                      reps=count) / count
        y = conv3d.conv3d_s1(xb, wb, use_kernel=True)
        flop = 2 * y.numel() * 27 * ci
        b = bound(nbytes(xb, wb, y), flop, torch.bfloat16)
        for key, value in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib)):
            total[key] += count * value
        moved += count * nbytes(xb, wb, y)
        ops += count * flop
        worst = max(worst, *errs.values())
        parts.append(f"{name} [{ci}->{co} at {d}x{h}x{w}, tile "
                     f"{conv3d.BLOCK_M}x{conv3d.tile_n(co)}] "
                     f"x{count}: max abs err fp32 {errs[torch.float32]:.3e} "
                     f"bf16 {errs[torch.bfloat16]:.3e}; bf16 kernel {ms:.4f} "
                     f"ms ({flop / ms / 1e9:.1f} TFLOP/s, "
                     f"{b['bound_ms'] / ms:.1%} of the bound) plain "
                     f"{plain:.4f} ms cuDNN {lib:.4f} ms "
                     f"({flop / lib / 1e9:.1f} TFLOP/s) bound "
                     f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    total.update(bound(moved, ops, torch.bfloat16))
    print("phase 4 K4 conv3d_s1 (median of 20): " + " | ".join(parts)
          + f" | per forward ({ops / 1e9:.1f} GFLOP): kernel "
          f"{total['ms']:.3f} ms ({ops / total['ms'] / 1e9:.1f} TFLOP/s, "
          f"{total['bound_ms'] / total['ms']:.1%} of the bound, "
          f"{total['ms'] / total['library_ms']:.2f}x cuDNN), cuDNN "
          f"{total['library_ms']:.3f} ms "
          f"({ops / total['library_ms'] / 1e9:.1f} TFLOP/s), plain {total['plain_ms']:.3f} ms, bound "
          f"{total['bound_ms']:.4f} ms ({total['bound_by']})", flush=True)
    return dict(max_abs_err=worst, **total)


def dcn_library(z, idx, wgt):
    """P1's function as one PyTorch call, ``F.embedding_bag`` in sum mode
    over z's rows with the corner tables as bags of 4 * K samples (the
    weights in z's dtype, as the probe casts them); timed, never used by
    the port."""
    k, n, c = z.shape
    flat = (idx.long() + (torch.arange(k, device=z.device) * n)[None, :, None]
            ).reshape(n, -1)
    table, per_sample = z.reshape(k * n, c), wgt.reshape(n, -1).to(z.dtype)
    return lambda: torch.nn.functional.embedding_bag(
        flat, table, per_sample_weights=per_sample, mode="sum")


def dcn_inputs(model, dev) -> dict:
    """Phase 4b's inputs at the flagship DepthNet DCN: x [1, fH, fW, 640]
    from the seed, the seeded model's tap weights ``taps`` [9, C / G, C]
    and ``groups``; offsets [1, fH, fW, 18] at the Pallas probe's scale
    (``probe``, randn * 1.5), from the seeded offset head (``seeded``, fp32,
    contiguous) and as serving hands them to P1 (``serving``: the bf16
    head's NCHW output seen through ``permute(0, 2, 3, 1)``, not copied);
    z of every tap in bf16 (``zb``) and fp32 (``z32``)."""
    from stereoscene_torch.ops import deform_conv

    dcn = model.img_view_transformer.depth_net.depth_conv[4]
    fh, fw = model.cfg.feature_size
    c, groups = dcn.weight.shape[0], dcn.groups
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(1, fh, fw, c, generator=gen, device=dev)
    taps = (dcn.weight.detach().reshape(c, c // groups, 9).permute(2, 1, 0)
            .contiguous())
    head = dcn.conv_offset
    with torch.no_grad():
        x_nchw = x.permute(0, 3, 1, 2).contiguous()  # as the ASPP hands it
        seeded = head(x_nchw).permute(0, 2, 3, 1)
        serving = torch.nn.functional.conv2d(
            x_nchw.bfloat16(), head.weight.bfloat16(),
            head.bias.bfloat16(), padding=1).permute(0, 2, 3, 1)
    offsets = {"probe": torch.randn(1, fh, fw, 18, generator=gen,
                                    device=dev) * 1.5,
               "seeded": seeded.contiguous(), "serving": serving}
    return dict(x=x, taps=taps, groups=groups, offsets=offsets,
                zb=deform_conv.dcn_z(x.bfloat16(), taps.bfloat16(), groups),
                z32=deform_conv.dcn_z(x, taps, groups))


def phase_dcn(model, dev, deform_conv) -> dict:
    """P1 at the flagship DepthNet DCN: x [1, fH, fW, 640], G = 4, the
    seeded model's tap weights; offsets at the probe's scale, from the
    seeded offset head and as serving hands them (bf16, permuted). Times in
    bf16 (serving's dtype); the kernels-line entry takes the seeded fp32
    offsets, as earlier PRs timed it."""
    from stereoscene_torch import _build

    inputs = dcn_inputs(model, dev)
    x, taps, groups = inputs["x"], inputs["taps"], inputs["groups"]
    offsets, zb, z32 = inputs["offsets"], inputs["zb"], inputs["z32"]
    fh, fw, c = x.shape[1:]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs = {}
    for name, off in offsets.items():
        idx, wgt = deform_conv.dcn_corner_tables(off, fh, fw)
        for z, tol in ((z32, 1e-5), (zb, 2e-2)):
            want = deform_conv.dcn_gather_plain(z, off)
            limit = tol * float(want.float().abs().max())
            got = deform_conv.dcn_gather_kernel(z, off)
            errs[name, z.dtype] = check_close(
                f"dcn gather {name} {z.dtype}", got, want, limit, 0.0)
            if not torch.equal(got, deform_conv.dcn_gather_kernel(z, off)):
                raise AssertionError(f"dcn gather {name} {z.dtype}: two "
                                     "launches differ")
            errs[name, z.dtype, "library"] = check_close(
                f"dcn embedding_bag {name} {z.dtype}",
                dcn_library(z, idx, wgt)(), want, limit, 0.0)
        with torch.no_grad():
            want = deform_conv.deform_conv2d_plain(x, off, taps, groups)
            errs[name, "route"] = check_close(
                f"dcn route {name}",
                deform_conv.deform_conv2d(x, off, taps, groups,
                                          use_kernel=True),
                want, 1e-5 * float(want.abs().max()), 0.0)

    g = torch.randn(1, fh, fw, c, generator=gen, device=dev)
    ins = [t.clone().requires_grad_() for t in (x, offsets["probe"], taps)]
    (deform_conv.deform_conv2d(*ins, groups, use_kernel=True) * g).sum() \
        .backward()
    ref = [t.clone().requires_grad_() for t in (x, offsets["probe"], taps)]
    (deform_conv.deform_conv2d_plain(*ref, groups) * g).sum().backward()
    grad_errs = [check_close(f"dcn backward d{n}", a.grad, b.grad,
                             1e-5 * float(b.grad.abs().max()), 0.0)
                 for n, a, b in zip(("x", "offsets", "weights"), ins, ref)]
    if float(ins[1].grad.abs().max()) == 0.0:
        raise AssertionError("dcn backward: zero offset gradient")
    del ins, ref, g

    off, serving = offsets["seeded"], offsets["serving"]
    idx, wgt = deform_conv.dcn_corner_tables(off, fh, fw)
    xb, tb = x.bfloat16(), taps.bfloat16()
    ms = cuda_ms(lambda: deform_conv.dcn_gather_kernel(zb, off))
    ms_serving = cuda_ms(lambda: deform_conv.dcn_gather_kernel(zb, serving))
    plain = cuda_ms(lambda: deform_conv.dcn_gather_plain(zb, off))
    lib = cuda_ms(dcn_library(zb, idx, wgt))
    ms32 = cuda_ms(lambda: deform_conv.dcn_gather_kernel(z32, off))
    lib32 = cuda_ms(dcn_library(z32, idx, wgt))
    zms = cuda_ms(lambda: deform_conv.dcn_z(xb, tb, groups))
    with torch.no_grad():
        route = cuda_ms(lambda: deform_conv.deform_conv2d(
            xb, off, tb, groups, use_kernel=True))
        route_plain = cuda_ms(lambda: deform_conv.deform_conv2d_plain(
            xb, off, tb, groups))
    out = deform_conv.dcn_gather_kernel(zb, off)
    # the bare C entry, 20 calls back to back: device time without the
    # wrapper's host side
    bare, entry = {}, _build.load_kernels().stereoscene_dcn_gather
    stream = _build.stream_ptr(dev)
    for name, o in (("seeded", off), ("serving", serving)):
        args = deform_conv.dcn_gather_args(zb, o)
        bare[name] = cuda_ms(lambda: _build.check(entry(
            zb.data_ptr(), o.data_ptr(), out.data_ptr(), *args, stream),
            "stereoscene_dcn_gather"), reps=20) / 20
    # z, the offsets and the output; 36 fp32 multiply-adds per output value
    moved = nbytes(zb, off, out)
    p1 = dict(max_abs_err=max(v for k, v in errs.items()
                              if k[1] == torch.float32 and len(k) == 2),
              ms=ms, plain_ms=plain, library_ms=lib,
              **bound(moved, 2 * 36 * out.numel(), torch.float32))
    share = p1["bound_ms"] / bare["seeded"]
    print(f"phase 4b P1 dcn_gather [1, {fh}, {fw}, {c}] G {groups}: max abs "
          f"err kernel vs plain fp32 probe {errs['probe', torch.float32]:.3e} "
          f"seeded {errs['seeded', torch.float32]:.3e} serving "
          f"{errs['serving', torch.float32]:.3e}, bf16 probe "
          f"{errs['probe', torch.bfloat16]:.3e} seeded "
          f"{errs['seeded', torch.bfloat16]:.3e} serving (bf16 offsets, "
          f"permuted NCHW view) {errs['serving', torch.bfloat16]:.3e}; two "
          f"launches bitwise equal for each; embedding_bag vs plain fp32 "
          f"{errs['seeded', torch.float32, 'library']:.3e} bf16 "
          f"{errs['seeded', torch.bfloat16, 'library']:.3e}; route vs plain "
          f"gather DCN fp32 probe {errs['probe', 'route']:.3e} seeded "
          f"{errs['seeded', 'route']:.3e} serving "
          f"{errs['serving', 'route']:.3e}; backward dx {grad_errs[0]:.3e} "
          f"doffsets {grad_errs[1]:.3e} dweights {grad_errs[2]:.3e}; median "
          f"of 20, bf16: kernel {ms:.4f} ms (serving offsets {ms_serving:.4f}"
          f" ms) plain {plain:.4f} ms embedding_bag {lib:.4f} ms bound "
          f"{p1['bound_ms']:.4f} ms ({p1['bound_by']}, {moved / 1e6:.1f} MB);"
          f" bare C entry (20 back to back) {bare['seeded']:.4f} ms, "
          f"{share:.1%} of the bound (serving offsets "
          f"{bare['serving']:.4f} ms); fp32: kernel {ms32:.4f} ms "
          f"embedding_bag {lib32:.4f} ms; whole DCN bf16: z-gather route "
          f"{route:.4f} ms (z {zms:.4f} ms), plain gather DCN "
          f"{route_plain:.4f} ms", flush=True)
    return p1


def take_rows_inputs(dev) -> tuple:
    """Phase 4c's inputs, the Pallas probe's shapes: feat [7680, 128] fp32
    and int32 indices for each of the three layouts, [1024, 128] per
    element, [1024, 1] per row and [1024] flat -> (feat, {layout: idx})."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rows, c, m = 7680, 128, 1024
    feat = torch.randn(rows, c, generator=gen, device=dev)
    layouts = {name: torch.randint(0, rows, shape, generator=gen, device=dev,
                                   dtype=torch.int32)
               for name, shape in (("per element", (m, c)),
                                   ("per row", (m, 1)), ("flat", (m,)))}
    return feat, layouts


def phase_take_rows(dev, gather) -> dict:
    """P2 at the probe's shapes for its three index layouts; the
    kernels-line entry sums the three (one launch each). The bound counts
    the table rows this run's indices touch, not the whole table. The
    kernel's own device time comes from torch.profiler: a call's host side
    outlasts it."""
    feat, layouts = take_rows_inputs(dev)
    (rows, c), m = feat.shape, layouts["flat"].shape[0]
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    moved, parts = 0, []
    for name, idx in layouts.items():
        shape = tuple(idx.shape)
        got = gather.take_along_rows(feat, idx, use_kernel=True)
        want = gather.take_along_rows(feat, idx, use_kernel=False)
        idx64 = idx.long().reshape(m, -1)
        lib_out = torch.take_along_dim(feat, idx64, dim=0)
        if not (torch.equal(got, want) and torch.equal(lib_out, want)):
            raise AssertionError(f"take_rows {name}: not bitwise equal")
        ms = cuda_ms(lambda: gather.take_along_rows(feat, idx,
                                                    use_kernel=True))
        plain = cuda_ms(lambda: gather.take_along_rows(feat, idx,
                                                       use_kernel=False))
        lib = cuda_ms(lambda: torch.take_along_dim(feat, idx64, dim=0))
        device = kernel_ms(lambda: gather.take_along_rows(feat, idx),
                           "take_rows")
        if idx64.shape[1] == 1:
            touched = int(torch.unique(idx64).numel()) * c * 4
        else:  # distinct (row, column) elements
            cols = torch.arange(c, device=dev)
            touched = int(torch.unique(idx64 * c + cols).numel()) * 4
        b = nbytes(idx, got) + touched
        moved += b
        for key, value in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib)):
            total[key] += value
        kernel = "not measured" if device is None else f"{device:.4f} ms"
        parts.append(f"{name} idx {list(shape)}: whole call {ms:.4f} ms "
                     f"(the kernel's device time {kernel}) plain "
                     f"{plain:.4f} ms take_along_dim {lib:.4f} ms, "
                     f"{b / 1e6:.2f} MB")
    total.update(bound(moved, 0, torch.float32))
    print(f"phase 4c P2 take_rows feat [{rows}, {c}] -> [{m}, {c}], bitwise "
          f"equal to plain in all three layouts (median of 20): "
          + " | ".join(parts) + f" | sum bound {total['bound_ms']:.5f} ms "
          "(bytes; launch latency dominates at this size)", flush=True)
    return dict(max_abs_err=0.0, **total)


# phase 4d: the m2f cell's deformable attention call: its levels, queries
# (one a value row), heads, points and width
MSDEFORM_LEVELS = ((64, 64, 8), (32, 32, 4), (16, 16, 2))
MSDEFORM_HEADS, MSDEFORM_POINTS, MSDEFORM_C = 8, 4, 192


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches, by torch.profiler after one warm-up."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_msdeform(dev, msdeform_attn) -> dict:
    """The 3D deformable attention kernel at the m2f cell's shapes (bf16
    values and weights, fp32 locations about each query's cell) against its
    plain route: its gap to a float32 run of the plain route within the
    plain route's own, the whole call's and the kernel's device ms beside
    the plain route's, the device operations of each and the bound (the
    benchmark's count of the call: values, locations, weights and output
    once)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    shapes, heads, points, c = (MSDEFORM_LEVELS, MSDEFORM_HEADS,
                                MSDEFORM_POINTS, MSDEFORM_C)
    n = sum(x * y * z for x, y, z in shapes)
    value = torch.randn(1, n, c, generator=gen, device=dev).bfloat16()
    # each query's cell centre, offset by 1.7 cells' standard deviation at
    # every level, as the benchmark's seeded weights sample
    refs = []
    for x, y, z in shapes:
        grid = torch.meshgrid(*((torch.arange(k, device=dev) + 0.5) / k
                                for k in (x, y, z)), indexing="ij")
        refs.append(torch.stack(grid, -1).reshape(-1, 3))
    size = torch.tensor(shapes, dtype=torch.float32, device=dev)
    loc = torch.cat(refs)[None, :, None, None, None] + 1.7 * torch.randn(
        1, n, heads, len(shapes), points, 3, generator=gen,
        device=dev) / size[:, None]
    attn = torch.softmax(torch.randn(1, n, heads, len(shapes) * points,
                                     generator=gen, device=dev), -1)
    attn = attn.bfloat16().reshape(1, n, heads, len(shapes), points)

    def call(use_kernel=None):
        return msdeform_attn.msdeform_attn_3d(value, shapes, loc, attn,
                                              heads, use_kernel)

    got, plain = call(), call(False)
    ref = msdeform_attn.msdeform_attn_3d(value.float(), shapes, loc,
                                         attn.float(), heads, False)
    scale = float(ref.abs().max())
    gap, plain_gap = max_err(got, ref), max_err(plain, ref)
    if not gap <= plain_gap + 1e-5 * scale:
        raise AssertionError(f"msdeform_attn_3d kernel: gap to float32 "
                             f"{gap:.3e} above the plain route's "
                             f"{plain_gap:.3e}")
    ms = cuda_ms(call)
    device = kernel_ms(call, "msdeform3d")
    plain_ms = cuda_ms(lambda: call(False), iters=5)
    ops, plain_ops = device_ops(call), device_ops(lambda: call(False))
    samples = n * heads * len(shapes) * points
    work = bound(nbytes(value, loc, attn, got),
                 samples * 8 * (c // heads) * 2, torch.bfloat16)
    kernel = "not measured" if device is None else f"{device:.4f} ms"
    share = "" if device is None else \
        f", {100 * work['bound_ms'] / device:.2f}% of the bound"
    print(f"phase 4d msdeform_attn_3d value [1, {n}, {c}] bf16, {heads} "
          f"heads x {len(shapes)} levels {list(shapes)} x {points} points: "
          f"gap to float32 {gap:.3e} (plain route {plain_gap:.3e}, max|ref| "
          f"{scale:.3f}); whole call {ms:.4f} ms (the kernel's device time "
          f"{kernel}{share}), {ops} device op(s); plain {plain_ms:.4f} ms, "
          f"{plain_ops} device ops; bound {work['bound_ms']:.5f} ms "
          f"({work['bound_by']})", flush=True)
    return dict(max_abs_err=gap, ms=ms, kernel_ms=device, plain_ms=plain_ms,
                device_ops=ops, plain_device_ops=plain_ops, **work)


def lidar_scan(rng, n: int, raw_ids) -> tuple:
    """A seeded velodyne sweep of ``n`` points (x forward, y left, z up,
    reflectance; float32 [n, 4]) and its lidarseg labels (uint32: a raw id
    of ``raw_ids`` below an instance id). 80% lie in the camera's view (3-58
    m ahead, |y| < 0.85 x, |z| < 0.25 x); 10% repeat some of those 1.05-1.6x
    farther along the same ray, so several points land on one pixel; 10%
    lie anywhere within 60 m, behind the car and outside the image
    included."""
    n_dup = n_out = n // 10
    n_in = n - n_dup - n_out
    x = rng.uniform(3.0, 58.0, n_in)
    seen = np.stack([x, x * rng.uniform(-0.85, 0.85, n_in),
                     x * rng.uniform(-0.25, 0.25, n_in)], axis=1)
    dup = seen[rng.integers(0, n_in, n_dup)] * rng.uniform(1.05, 1.6,
                                                           (n_dup, 1))
    out = np.stack([rng.uniform(-60.0, 60.0, n_out),
                    rng.uniform(-60.0, 60.0, n_out),
                    rng.uniform(-3.0, 3.0, n_out)], axis=1)
    xyz = np.concatenate([seen, dup, out])
    pts = np.concatenate([xyz, rng.random((n, 1))], axis=1)
    labels = (rng.choice(raw_ids, n).astype(np.uint32)
              | (rng.integers(0, 64, n).astype(np.uint32) << 16))
    return pts.astype(np.float32), labels


def write_semkitti_tree(root: str, n_frames: int, n_train: int) -> tuple:
    """A SemanticKITTI tree at full size under ``root``: sequence 08 (the
    val split) with ``n_frames`` frames and sequence 00 (train) with
    ``n_train``: seeded 376x1241 stereo PNG pairs, a calib.txt of the
    flagship calibration (fx 707, baseline 0.54 m, the velodyne axes of
    bench.py's rotation), ``voxels/*.bin`` frame markers, voxel labels
    [256, 256, 32] uint8 (60% empty, 10% ignore 255), and per frame a
    ``velodyne/*.bin`` sweep of ``N_LIDAR_POINTS`` points (an HDL-64
    sweep's size) with its ``labels/*.label`` lidarseg file
    -> (data_root, ann_file, lidar_root), the lidar root also the lidarseg
    root."""
    from PIL import Image

    from stereoscene_torch.data.labels import LEARNING_MAP

    lidar_root = os.path.join(root, "dataset", "sequences")
    ann = os.path.join(root, "labels")
    p2 = f"{FX} 0 620.5 0 0 {FX} 188.0 0 0 0 1 0"
    p3 = f"{FX} 0 620.5 {-FX * BASELINE} 0 {FX} 188.0 0 0 0 1 0"
    rng = np.random.default_rng(SEED + 100)
    ramp = np.linspace(0, 160, 1241)[None, :, None]
    for seq_id, count in (("08", n_frames), ("00", n_train)):
        seq = os.path.join(lidar_root, seq_id)
        for sub in ("image_2", "image_3", "voxels", "velodyne", "labels"):
            os.makedirs(os.path.join(seq, sub))
        os.makedirs(os.path.join(ann, seq_id))
        with open(os.path.join(seq, "calib.txt"), "w") as f:
            f.write(f"P0: {p2}\nP1: {p3}\nP2: {p2}\nP3: {p3}\n"
                    "Tr: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
        for i in range(count):
            fid = f"{i:06d}"
            for cam in ("image_2", "image_3"):
                img = ramp + rng.integers(0, 96, (376, 1241, 3))
                Image.fromarray(img.astype(np.uint8)).save(
                    os.path.join(seq, cam, fid + ".png"))
            with open(os.path.join(seq, "voxels", fid + ".bin"), "wb") as f:
                f.write(b"\0")
            occ = rng.integers(1, 20, LABEL_SHAPE)
            occ[rng.random(LABEL_SHAPE) < 0.6] = 0
            occ[rng.random(LABEL_SHAPE) < 0.1] = 255
            np.save(os.path.join(ann, seq_id, f"{fid}_1_1.npy"),
                    occ.astype(np.uint8))
            pts, labels = lidar_scan(rng, N_LIDAR_POINTS,
                                     sorted(LEARNING_MAP))
            pts.tofile(os.path.join(seq, "velodyne", fid + ".bin"))
            labels.tofile(os.path.join(seq, "labels", fid + ".label"))
    return root, ann, lidar_root


def phase_eval(dev, build, card: str, seeded_init_, tmp: str,
               tree: tuple) -> dict:
    """The eval CLI (``stereoscene_torch.tools.test.main``) on the card
    over the full-size SemanticKITTI ``tree``, with a seeded checkpoint
    written under ``tmp``: once writing predictions, once scoring; then the
    same checkpoint through ``run_evaluation`` without the kernels. Returns
    the launches of the scoring run."""
    import stereoscene_torch
    from stereoscene_torch.config import Config, merge_from_options
    from stereoscene_torch.data.labels import inv_map
    from stereoscene_torch.engine.eval import make_eval_step
    from stereoscene_torch.engine.loop import run_evaluation
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.tools import test as cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    t0 = time.perf_counter()
    root, ann, _ = tree
    opts = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    cfg = Config.fromfile(config)
    merge_from_options(cfg, opts)
    model = BEVDepthOccupancy(DetectorConfig.from_config(cfg),
                              device=dev, label_shape=LABEL_SHAPE)
    seeded_init_(model, SEED)
    ckpt = os.path.join(tmp, "seeded.pth")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    setup_s = time.perf_counter() - t0
    argv = [config, "--checkpoint", ckpt, "--device", dev.type]
    sub, pred_dir = os.path.join(tmp, "submission"), os.path.join(
        tmp, "pred")
    cli.main(argv + ["--submission-dir", sub, "--save-pred-dir",
                     pred_dir, "--cfg-options", *opts])
    build.launch_counts.clear()
    res_k = cli.main(argv + ["--cfg-options", *opts])
    launches = dict(build.launch_counts)

    frames, loader = cli.make_loader(cfg, "val", 1)
    eval_step, preds = make_eval_step(LABEL_SHAPE), []

    def step(model, batch, state, use_kernel=None):
        pred, state = eval_step(model, batch, state, use_kernel)
        preds.append(pred.to(torch.uint8).cpu().numpy())
        return pred, state

    build.launch_counts.clear()
    res_p = run_evaluation(model, step, loader, use_kernel=False,
                           progress=False)
    if build.launch_counts:
        raise AssertionError(f"eval without kernels launched "
                             f"{dict(build.launch_counts)}")
    pred_p = np.concatenate(preds)
    lut, pred_k = inv_map(), []
    for frame in frames:
        name = f"{frame.sequence}_{frame.frame_id}"
        pred_k.append(np.load(os.path.join(pred_dir, name + ".npy")))
        raw = np.fromfile(os.path.join(
            sub, "sequences", frame.sequence, "predictions",
            frame.frame_id + ".label"), np.uint16)
        if raw.size != int(np.prod(LABEL_SHAPE)) or not np.array_equal(
                raw, lut[pred_k[-1].reshape(-1)]):
            raise AssertionError(f"eval .label file of {name}: "
                                 f"{raw.size} values, not the inv_map "
                                 "of its .npy prediction")
    pred_k = np.stack(pred_k)
    if res_k["eval_frames"] != N_EVAL_FRAMES or pred_k.shape != (
            N_EVAL_FRAMES,) + LABEL_SHAPE or pred_p.shape != pred_k.shape:
        raise AssertionError(f"eval: {res_k['eval_frames']} frames, "
                             f"predictions {pred_k.shape} / {pred_p.shape}")
    agree = float((pred_k == pred_p).mean())
    diffs = {k: abs(res_k[k] - res_p[k]) for k in res_k
             if k.startswith("semkitti_")}
    bad = {k: v for k, v in diffs.items() if not v <= 0.01
           and not (math.isnan(res_k[k]) and math.isnan(res_p[k]))}
    if agree < 0.9999 or bad:
        raise AssertionError(f"eval kernels vs plain: voxel agreement "
                             f"{agree:.6f} (limit 0.9999), metrics off by "
                             f"more than 0.01: {bad}")
    keys = ("semkitti_SC_IoU", "semkitti_SSC_mIoU")
    print(f"phase 8 fp32 eval CLI on {card}: {N_EVAL_FRAMES} frames of "
          f"376x1241 stereo PNGs -> {cfg['data_config']['input_size']}, "
          f"gt_occ {list(LABEL_SHAPE)} (checkpoint written in "
          f"{setup_s:.1f} s); tools.test.main with the kernels eval_time_s "
          f"{res_k['eval_time_s']:.3f} "
          f"({N_EVAL_FRAMES / res_k['eval_time_s']:.3f} frames/s), "
          f"run_evaluation without {res_p['eval_time_s']:.3f} "
          f"({N_EVAL_FRAMES / res_p['eval_time_s']:.3f} frames/s), loading "
          f"and decoding included; voxel agreement {agree:.6f}; "
          f"{', '.join(f'{k} {res_k[k]}' for k in keys)}; largest metric "
          f"difference {max(diffs.values()):.4f} points; {N_EVAL_FRAMES} "
          f".label files equal to inv_map of the .npy predictions; launches "
          f"{launches}", flush=True)
    return launches


def phase_train_cli(dev, build, card: str, tmp: str, tree: tuple) -> dict:
    """The train CLI (``stereoscene_torch.tools.train.main``) on the card:
    the flagship config at its ``samples_per_gpu`` (B = 2) in bf16 for
    ``CLI_EPOCHS`` epochs over the tree's train frames in index order
    (``--deterministic-data``) with LiDAR depth, then the loop's eval over
    the val frames; then the eval CLI on the run's ``ckpts/``. Returns the
    launches of the training run, its eval included, its first step's
    logs, the ``ckpts/`` directory and the eval CLI's metrics."""
    import stereoscene_torch
    from stereoscene_torch.config import Config, merge_from_options
    from stereoscene_torch.data import (
        PipelineConfig,
        SemanticKittiIndex,
        SemanticKittiPipeline,
    )
    from stereoscene_torch.engine.checkpoint import CheckpointManager
    from stereoscene_torch.engine.loop import to_device
    from stereoscene_torch.tools import test as test_cli
    from stereoscene_torch.tools import train as train_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    root, ann, lidar_root = tree
    val_opts = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    opts = val_opts + [
        f"data.train.data_root={root}", f"data.train.ann_file={ann}",
        f"lidar_root={lidar_root}", f"lidarseg_root={lidar_root}"]
    cfg = Config.fromfile(config)
    merge_from_options(cfg, list(opts))

    # one train frame's LiDAR products, as the CLI's pipeline makes them
    dcfg = cfg["data_config"]
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=tuple(dcfg["input_size"]), resize=tuple(dcfg["resize"]),
        rot=tuple(dcfg["rot"]), flip=dcfg["flip"],
        crop_h=tuple(dcfg["crop_h"]), is_train=True, load_lidar_depth=True,
        point_cloud_range=tuple(cfg["point_cloud_range"])))
    frame = SemanticKittiIndex(data_root=root, ann_file=ann, split="train",
                               lidar_root=lidar_root,
                               lidarseg_root=lidar_root).frames[0]
    sample = pipe(frame, seed=SEED)
    hits = [int((sample["gt_depth"][eye] > 0).sum()) for eye in range(2)]
    lidar_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe._lidar_products(frame, sample)
        lidar_ms.append((time.perf_counter() - t0) * 1e3)
    if min(hits) < N_LIDAR_POINTS // 2:
        raise AssertionError(f"LiDAR products: gt_depth pixels per eye "
                             f"{hits} of {N_LIDAR_POINTS} points")

    steps, peaks = [], []

    def record(state, epoch, it, logs):
        steps.append({k: float(v) for k, v in logs.items()})
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)

    work_dir = os.path.join(tmp, "train_cli")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    state = train_cli.main(
        [config, "--work-dir", work_dir, "--device", dev.type, "--bf16",
         "--profile", "--deterministic-data", "--max-epochs",
         str(CLI_EPOCHS), "--cfg-options", *opts],
        hooks=[record])
    run_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    batch_size = cfg["data"]["samples_per_gpu"]
    n_steps = CLI_EPOCHS * (N_TRAIN_FRAMES // batch_size)
    if len(steps) != n_steps or state.step != n_steps:
        raise AssertionError(f"train CLI: {len(steps)} steps logged, state "
                             f"step {state.step}, want {n_steps}")
    for i, logs in enumerate(steps):
        if not all(math.isfinite(v) for v in logs.values()):
            raise AssertionError(f"train CLI step {i}: {logs}")
        if not logs.get("loss_depth", 0.0) > 0.0:
            raise AssertionError(f"train CLI step {i}: no depth loss {logs}")
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        evals = [r["eval"] for r in map(json.loads, f) if "eval" in r]
    if len(evals) != 1 or evals[0]["eval_frames"] != N_EVAL_FRAMES:
        raise AssertionError(f"train CLI: evals {evals}")
    for name in ("gwc_warp", "dcn_gather", "lift_splat_fused"):
        if launches.get(name, 0) < 1:
            raise AssertionError(f"train CLI: {name} never launched "
                                 f"({launches})")
    ckpts = os.path.join(work_dir, "ckpts")
    left = sorted(os.listdir(ckpts))
    latest = CheckpointManager(ckpts).latest_step
    saved = torch.load(os.path.join(ckpts, f"{latest}.pth"),
                       map_location="cpu", weights_only=True)["state_dict"]
    trained = state.model.state_dict()
    if latest != n_steps or saved.keys() != trained.keys() or not all(
            torch.equal(saved[k], trained[k].cpu()) for k in saved):
        raise AssertionError(f"train CLI: ckpts/ step {latest} does not "
                             "hold the trained weights")
    bad = [k for k, v in trained.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    # the trained model on the first val frame, as the loop's eval runs it
    state.model.eval()
    batch = to_device(next(iter(test_cli.make_loader(cfg, "val", 1)[1])), dev)
    logits = state.model(batch)["output_voxels"].float()
    if bad or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"train CLI: non-finite trained tensors {bad[:5]}"
                             f" or eval logits")
    empty = float((logits.argmax(-1) == 0).float().mean())
    del saved, trained, state, batch, logits

    build.launch_counts.clear()
    res = test_cli.main([config, "--checkpoint", ckpts, "--device", dev.type,
                         "--cfg-options", *val_opts])
    loop = evals[0]
    diffs = {k: abs(res[k] - loop[k]) for k in loop
             if k.startswith("semkitti_")}
    largest = max((v for v in diffs.values() if not math.isnan(v)),
                  default=0.0)
    bad = {k: v for k, v in diffs.items() if not v <= 0.01
           and not (math.isnan(res[k]) and math.isnan(loop[k]))}
    if len(diffs) < 20 or bad:
        raise AssertionError(f"eval CLI on ckpts vs the loop's eval: off by "
                             f"more than 0.01 points: {bad}")
    ms = [logs["step_time_s"] * 1e3 for logs in steps]
    terms = [{k: round(v, 5) for k, v in logs.items()
              if k.startswith("loss")} for logs in steps]
    print(f"phase 9 bf16 train CLI on {card}: {EVAL_CONFIG} B = "
          f"{batch_size}, {CLI_EPOCHS} epochs of {N_TRAIN_FRAMES} frames "
          f"with {N_LIDAR_POINTS}-point LiDAR sweeps; gt_depth pixels per "
          f"eye {hits} (points_count {int(sample['points_count'])}), one "
          f"frame's LiDAR products on the host "
          f"{statistics.median(lidar_ms):.2f} ms (median of 5; samples "
          f"{', '.join(f'{t:.2f}' for t in lidar_ms)}); losses per step "
          f"{terms}; ms per step {statistics.median(ms[1:]):.1f} (median of "
          f"the last {n_steps - 1}; samples "
          f"{', '.join(f'{t:.1f}' for t in ms)}); peak memory in training "
          f"{max(peaks):.2f} GiB; whole run {run_s:.1f} s; ckpts/ holds "
          f"{left}, the latest equal to the trained weights; the trained "
          f"model's fp32 logits on val frame 0 finite, {empty:.4f} of the "
          f"voxel grid predicted empty; eval CLI on "
          f"ckpts vs the loop's eval: largest metric difference "
          f"{largest:.4f} points over {len(diffs)} metrics "
          f"({sum(math.isnan(v) for v in diffs.values())} NaN in both), "
          f"semkitti_SC_IoU "
          f"{res['semkitti_SC_IoU']}, semkitti_SSC_mIoU "
          f"{res['semkitti_SSC_mIoU']}; launches {launches}", flush=True)
    return dict(launches=launches, first_step=steps[0], ckpts=ckpts,
                metrics=res)


def param_digest(model) -> int:
    """A digest of every parameter's bits: the sum of each fp32 word, as
    an integer, times a position weight (int64, wrapping)."""
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    bits = flat.view(torch.int32).long()
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return int((bits * weights).sum())


@contextlib.contextmanager
def timed_gradient_reduce(train_module, record: list):
    """Within the block ``train_module.reduce_gradients`` (the train step
    looks it up at each call) appends (ms between two device
    synchronisations, bytes reduced) to ``record`` at each call."""
    reduce = train_module.reduce_gradients

    def timed(grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(grads)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3,
                       sum(g.numel() * g.element_size() for g in grads)))
        return out

    train_module.reduce_gradients = timed
    try:
        yield
    finally:
        train_module.reduce_gradients = reduce


def dp_rank(rank: int, url: str, device_type: str, train_argv: list,
            eval_argv: list, out: str) -> None:
    """One rank of phase 10, in a spawned process: joins the two-rank gloo
    group at ``url`` on the one card, runs the train CLI (``train_argv``,
    the group already joined), then the eval CLI (``eval_argv``), and
    writes its records to ``out`` as JSON."""
    from stereoscene_torch import _build, parallel
    from stereoscene_torch.engine import train as train_module
    from stereoscene_torch.tools import test as test_cli
    from stereoscene_torch.tools import train as train_cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.init_distributed(url, 2, rank, device_type, backend="gloo",
                              timeout_s=DP_TIMEOUT_S)
    steps, digests, peaks, reduces = [], [], [], []

    def record(state, epoch, it, logs):
        steps.append({k: float(v) for k, v in logs.items()})
        digests.append(param_digest(state.model))
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)

    try:
        _build.launch_counts.clear()
        with timed_gradient_reduce(train_module, reduces):
            state = train_cli.main(train_argv, hooks=[record])
        train_launches = dict(_build.launch_counts)
        final = state.step
        del state
        torch.cuda.empty_cache()
        _build.launch_counts.clear()
        metrics = test_cli.main(eval_argv)
        eval_launches = dict(_build.launch_counts)
    finally:
        parallel.shutdown()
    with open(out, "w") as f:
        json.dump(dict(steps=steps, digests=digests, peaks=peaks,
                       reduces=reduces, final_step=final,
                       train_launches=train_launches,
                       eval_launches=eval_launches, metrics=metrics), f)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_data_parallel(dev, build, card: str, tmp: str, tree: tuple,
                        phase9: dict) -> tuple:
    """Phase 10: data-parallel training and multi-process eval. Two ranks
    spawned on the one card over gloo (NCCL refuses two ranks on one
    device) each run the train CLI on the flagship config at B = 1 (a
    global batch of 2, phase 9's) in bf16 with ``--deterministic-data`` for
    one epoch (2 steps, then the loop's eval of the val frames, two a rank),
    then the eval CLI on phase 9's ``ckpts/``; then one rank over NCCL for
    2 steps; then ``--flops`` on the flagship eval forward. Returns the
    launches of every run, summed, and the ``--flops`` line's GFLOP."""
    import io

    import stereoscene_torch
    from stereoscene_torch.engine import train as train_module
    from stereoscene_torch.tools import test as test_cli
    from stereoscene_torch.tools import train as train_cli

    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    root, ann, lidar_root = tree
    val_opts = [f"data.val.data_root={root}", f"data.val.ann_file={ann}"]
    opts = val_opts + [
        f"data.train.data_root={root}", f"data.train.ann_file={ann}",
        f"lidar_root={lidar_root}", f"lidarseg_root={lidar_root}"]
    train_argv = [config, "--device", dev.type, "--bf16", "--profile",
                  "--deterministic-data", "--batch-size", "1",
                  "--max-epochs", "1", "--work-dir",
                  os.path.join(tmp, "dp_train"), "--cfg-options", *opts,
                  "evaluation.interval=1"]
    eval_argv = [config, "--checkpoint", phase9["ckpts"], "--device",
                 dev.type, "--cfg-options", *val_opts]

    ctx = torch.multiprocessing.get_context("spawn")
    url = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(tmp, f"dp_rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dp_rank, args=(r, url, dev.type, train_argv,
                                                eval_argv, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 2 * DP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    if any(p.exitcode for p in procs):
        raise AssertionError(f"phase 10 ranks exited with "
                             f"{[p.exitcode for p in procs]}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))

    a, b = ranks
    n_steps = N_TRAIN_FRAMES // 2
    if (len(a["steps"]) != n_steps or a["final_step"] != n_steps
            or b["final_step"] != n_steps):
        raise AssertionError(f"phase 10: {len(a['steps'])} steps logged, "
                             f"final steps {a['final_step']} / "
                             f"{b['final_step']}, want {n_steps}")
    terms = [{k: v for k, v in logs.items() if k.startswith("loss")}
             for logs in a["steps"]]
    if terms != [{k: v for k, v in logs.items() if k.startswith("loss")}
                 for logs in b["steps"]]:
        raise AssertionError(f"phase 10: the ranks' losses differ: {terms} "
                             f"vs {b['steps']}")
    if a["digests"] != b["digests"]:
        raise AssertionError(f"phase 10: parameter digests differ: "
                             f"{a['digests']} vs {b['digests']}")
    ref = phase9["first_step"]
    rel = {k: abs(v - ref[k]) / abs(ref[k]) for k, v in terms[0].items()}
    if not all(math.isfinite(v) for logs in terms for v in logs.values()) \
            or max(rel.values()) > 1e-3:
        raise AssertionError(f"phase 10 step 1 vs phase 9's B = 2 step 1: "
                             f"relative differences {rel} (limit 1e-3); "
                             f"{terms[0]} vs {ref}")
    for r in ranks:
        for name in ("gwc_warp", "dcn_gather", "lift_splat_fused"):
            if r["train_launches"].get(name, 0) < 1:
                raise AssertionError(f"phase 10: {name} never launched on a "
                                     f"rank ({r['train_launches']})")
    want = {k: v for k, v in phase9["metrics"].items()
            if k.startswith("semkitti_")}
    for r in ranks:
        got = {k: v for k, v in r["metrics"].items()
               if k.startswith("semkitti_")}
        same = got.keys() == want.keys() and all(
            got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k]))
            for k in want)
        if len(want) != 25 or not same or r["metrics"]["eval_frames"] != \
                N_EVAL_FRAMES:
            raise AssertionError(f"phase 10: two-rank eval CLI {got} vs "
                                 f"one-process {want}")

    # one rank over NCCL: the group's collectives and the gradient
    # all-reduce on the card
    nccl_reduces, nccl_steps = [], []
    build.launch_counts.clear()
    t1 = time.perf_counter()
    with timed_gradient_reduce(train_module, nccl_reduces):
        state = train_cli.main(
            [config, "--device", dev.type, "--bf16", "--deterministic-data",
             "--max-epochs", "1", "--work-dir", os.path.join(tmp, "dp_nccl"),
             "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
             "1", "--process-id", "0", "--cfg-options", *opts],
            hooks=[lambda state, epoch, it, logs: nccl_steps.append(
                {k: float(v) for k, v in logs.items()})])
    nccl_s = time.perf_counter() - t1
    nccl_launches = dict(build.launch_counts)
    if state.step != n_steps or len(nccl_steps) != n_steps or not all(
            math.isfinite(v) for logs in nccl_steps for v in logs.values()):
        raise AssertionError(f"phase 10 NCCL rank: step {state.step}, logs "
                             f"{nccl_steps}")
    del state
    torch.cuda.empty_cache()

    # --flops on the flagship eval forward, then its eval
    captured = io.StringIO()
    build.launch_counts.clear()
    with contextlib.redirect_stdout(captured):
        flops_res = test_cli.main(eval_argv + ["--flops"])
    flops_launches = dict(build.launch_counts)
    flops_line = next(ln for ln in captured.getvalue().splitlines()
                      if ln.startswith("[flops]"))
    flops_gflop = re.search(r": ([0-9.]+) GFLOP/call", flops_line)
    if flops_res["eval_frames"] != N_EVAL_FRAMES or flops_gflop is None:
        raise AssertionError(f"phase 10 --flops eval: {flops_res}, "
                             f"{flops_line}")

    ms = [[logs["step_time_s"] * 1e3 for logs in r["steps"]] for r in ranks]
    red = [r["reduces"] for r in ranks]
    frames_s = N_EVAL_FRAMES / max(r["metrics"]["eval_time_s"]
                                   for r in ranks)
    print(f"phase 10 data parallel on {card} (two gloo ranks time-slicing "
          f"one card: not a speed-up): {EVAL_CONFIG} B = 1 a rank, "
          f"{n_steps} bf16 steps then the loop's eval; losses per step "
          f"{[{k: round(v, 5) for k, v in t.items()} for t in terms]}, "
          f"equal on both ranks; step 1 vs phase 9's B = 2 step 1 largest "
          f"relative difference {max(rel.values()):.2e} (limit 1e-3); "
          f"parameter digests equal after every step; ms per step by rank "
          f"{[[round(t, 1) for t in m] for m in ms]}; peak GiB by rank "
          f"{[round(max(r['peaks']), 2) for r in ranks]}; gradient "
          f"all-reduce (gloo, the card's tensors) ms per step by rank "
          f"{[[round(t, 1) for t, _ in r] for r in red]}, "
          f"{red[0][0][1]} bytes; two-rank eval CLI on phase 9's ckpts/ "
          f"{N_EVAL_FRAMES} frames in {frames_s:.3f} frames/s, 25 semkitti "
          f"metrics equal to the one-process eval CLI's; both ranks' run "
          f"{ranks_s:.1f} s; one NCCL rank: {n_steps} finite steps, "
          f"losses {[round(s['loss_total'], 5) for s in nccl_steps]}, "
          f"gradient all-reduce ms {[round(t, 2) for t, _ in nccl_reduces]}"
          f" ({nccl_reduces[0][1]} bytes), whole run {nccl_s:.1f} s; "
          f"{flops_line}; launches by rank "
          f"{[r['train_launches'] for r in ranks]} + eval "
          f"{[r['eval_launches'] for r in ranks]}, NCCL {nccl_launches}, "
          f"--flops eval {flops_launches}", flush=True)
    launches = collections.Counter()
    for counts in ([r["train_launches"] for r in ranks]
                   + [r["eval_launches"] for r in ranks]
                   + [nccl_launches, flops_launches]):
        launches.update(counts)
    return dict(launches), flops_gflop.group(1)


def phase_fp32_forward(model, batch, build) -> None:
    """Flagship forward in fp32 with and without the kernels."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.launch_counts.clear()
    with_k = model(batch, use_kernel=True)
    counts = dict(build.launch_counts)
    without = model(batch, use_kernel=False)
    torch.cuda.synchronize()
    if any(counts.get(k) != 1 for k in ("gwc_warp", "lift_splat_fused",
                                        "dcn_gather")):
        raise AssertionError(f"fp32 forward launch counts {counts}")
    if build.launch_counts != counts:
        raise AssertionError("use_kernel=False launched a kernel")
    dp_err = max_err(with_k["depth_prob"], without["depth_prob"])
    ref = without["output_voxels"]
    scale = float(ref.abs().max())
    logit_err = max_err(with_k["output_voxels"], ref) / scale
    for name, out in with_k.items():
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"fp32 forward: non-finite {name}")
    if dp_err > 2e-4 or logit_err > 2e-3:
        raise AssertionError(
            f"fp32 forward: kernels vs plain depth_prob {dp_err:.3e} (limit "
            f"2e-4), logits / max|ref| {logit_err:.3e} (limit 2e-3)")
    print(f"phase 5 fp32 flagship forward: output_voxels "
          f"{list(ref.shape)}, depth_prob {list(without['depth_prob'].shape)}"
          f"; kernels vs plain: depth_prob max abs err {dp_err:.3e}, logits "
          f"max abs err / max|ref| {logit_err:.3e}; launches {counts}",
          flush=True)


def phase_serve(model, cfg, dev, build, card: str,
                requests: int = N_REQUESTS) -> tuple:
    """bf16 serving: one warm-up request, then ``requests`` timed ones.
    Returns the kernels' launches and the host ms of the timed requests."""
    torch.backends.cudnn.allow_tf32 = True
    model.to(torch.bfloat16)
    marks = {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name] = ev
        return hook

    finite = []
    hooks = [
        model.img_backbone.register_forward_pre_hook(mark("images")),
        model.img_view_transformer.register_forward_pre_hook(mark("view")),
        model.img_bev_encoder_backbone.register_forward_pre_hook(mark("bev")),
        model.pts_bbox_head.register_forward_hook(
            lambda _m, _i, out: finite.append(torch.isfinite(out).all())),
    ]
    batches = [_frames.frame(cfg, dev, SEED + 10 + i)
               for i in range(requests + 1)]
    stages, frames = [], []
    build.launch_counts.clear()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        classes = model.infer(batch)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        if classes.shape != (1, 256, 256, 32):
            raise AssertionError(f"request {i}: class map {classes.shape}")
        lo, hi = int(classes.min()), int(classes.max())
        if lo < 0 or hi >= cfg.out_channel:
            raise AssertionError(f"request {i}: classes in [{lo}, {hi}]")
        if i:  # request 0 is the warm-up
            frames.append(frame_ms)
            stages.append((
                marks["images"].elapsed_time(marks["view"]),
                marks["view"].elapsed_time(marks["bev"]),
                marks["bev"].elapsed_time(end)))
    launches = dict(build.launch_counts)
    for h in hooks:
        h.remove()
    if not all(bool(f) for f in finite):
        raise AssertionError("serving: non-finite logits")
    if model.plan_cache.misses != 1:
        raise AssertionError(
            f"serving: {model.plan_cache.misses} plans built for one "
            "calibration")
    med = [statistics.median(s[j] for s in stages) for j in range(3)]
    print(f"phase 6 bf16 serving on {card}: {requests} requests (+1 "
          f"warm-up) {cfg.input_size[0]}x{cfg.input_size[1]} stereo -> "
          f"[256, 256, 32] class maps in "
          f"[0, {cfg.out_channel}); median device ms images {med[0]:.3f} "
          f"view {med[1]:.3f} bev+upsample+argmax {med[2]:.3f}; host ms per "
          f"frame {statistics.median(frames):.3f} "
          f"(samples {', '.join(f'{f:.3f}' for f in frames)}); plan cache "
          f"hits {model.plan_cache.hits} misses {model.plan_cache.misses}; "
          f"launches {launches}", flush=True)
    return launches, frames


def train_batch(cfg, seed: int, dev) -> dict:
    """The flagship frame with seeded labels: gt_occ [1, 256, 256, 32] in
    [0, 20) with 10% ignore (255), and a sparse LiDAR-like gt_depth
    [1, 1, 384, 1280] (7% of pixels, depths in the model's range)."""
    gen = torch.Generator().manual_seed(seed)
    batch = _frames.frame(cfg, "cpu", seed)
    occ = torch.randint(0, 20, (1, 256, 256, 32), generator=gen)
    ignore = torch.rand(occ.shape, generator=gen) < 0.1
    batch["gt_occ"] = torch.where(ignore, 255, occ).to(torch.int32)
    h, w = cfg.input_size
    hit = torch.rand(1, 1, h, w, generator=gen) < 0.07
    lo, hi, _ = cfg.dbound
    depth = lo + (hi - lo) * torch.rand(1, 1, h, w, generator=gen)
    batch["gt_depth"] = depth * hit
    return {k: v.to(dev) for k, v in batch.items()}


def kernel_step_pair(cfg, batch, dev, build, train, loss_cfg, tag: str,
                     seeded_init_, model_cls, min_k4: int = 12) -> dict:
    """One fp32 loss and gradient of ``cfg``'s model (seeded weights) on
    ``batch``, built with K4 and run with the kernels (K1, P1, K4), and
    built and run without: the loss within 1e-4 relative, every gradient
    leaf within 2% (floor 1e-4 of the global scale), K1 and P1 launched
    once and K4 at least ``min_k4`` times with the kernels, nothing
    without. Returns the losses, terms, leaf count, floor and launches."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    runs = []
    for kernels in (True, False):
        model = model_cls(cfg, conv3d_kernel=kernels)
        seeded_init_(model, SEED)
        state = train.create_train_state(model)
        build.launch_counts.clear()
        total, losses, grads = train.loss_and_grads(
            state, batch, loss_cfg, use_kernel=kernels,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        runs.append((total, losses, grads, dict(build.launch_counts),
                     [n for n, _ in state.trainable]))
        del model, state
    (tk, lk, gk, ck, names), (tp, lp, gp, cp, _) = runs
    if (ck.get("gwc_warp") != 1 or ck.get("dcn_gather") != 1
            or ck.get("conv3d_s1", 0) < min_k4 or cp):
        raise AssertionError(f"{tag} fp32 step launches: kernels {ck}, "
                             f"plain {cp}")
    if not (torch.isfinite(tk)
            and abs(float(tk - tp)) <= 1e-4 * abs(float(tp))):
        raise AssertionError(f"{tag} fp32 step: loss {float(tk)} with the "
                             f"kernels, {float(tp)} without")
    scale = max(float(g.abs().max()) for g in gp)
    bad = []
    for name, a, b in zip(names, gk, gp):
        leaf = max(float(a.abs().max()), float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= max(2e-2 * leaf, 1e-4 * scale)):
            bad.append((name, err / leaf))
    if bad:
        worst = sorted(bad, key=lambda b: -b[1])[:5]
        raise AssertionError(f"{tag} fp32 step: {len(bad)} of {len(names)} "
                             f"grad leaves off, worst {worst}")
    torch.backends.cudnn.deterministic = False
    return dict(loss=float(tk), plain=float(tp), leaves=len(names),
                floor=1e-4 * scale, launches=ck,
                terms={k: round(float(v), 5) for k, v in lk.items()})


def phase_train(cfg, dev, build, train, seeded_init_, model_cls) -> dict:
    """(a) fp32 loss and gradients with the kernels and without; (b) six
    bf16 steps with the kernels. Returns the launches of (b)."""
    loss_cfg = train.LossConfig()
    batch = train_batch(cfg, SEED + 20, dev)
    pair = kernel_step_pair(cfg, batch, dev, build, train, loss_cfg,
                            "phase 7a", seeded_init_, model_cls)
    print(f"phase 7a fp32 train step, kernels vs plain: loss "
          f"{pair['loss']:.6f} vs {pair['plain']:.6f} ({pair['terms']}); "
          f"{pair['leaves']} grad leaves within 2% (floor "
          f"{pair['floor']:.2e}); launches {pair['launches']}", flush=True)

    torch.backends.cudnn.allow_tf32 = True
    model = model_cls(cfg, conv3d_kernel=True)
    seeded_init_(model, SEED)
    state = train.create_train_state(model)
    step = train.make_train_step(loss_cfg, bf16=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    build.launch_counts.clear()
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        # the same dropout and drop-path masks every step: one batch, so
        # the loss must fall
        state, logs = step(state, batch,
                           torch.Generator(device=dev).manual_seed(SEED))
        losses.append(float(logs["loss_total"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"bf16 steps: losses {losses}")
    per_step = {k: v / N_TRAIN_STEPS for k, v in launches.items()}
    if (per_step.get("gwc_warp") != 1 or per_step.get("dcn_gather") != 1
            or per_step.get("conv3d_s1", 0) < 12):
        raise AssertionError(f"bf16 steps: launches {launches}")
    print(f"phase 7b bf16 training, {N_TRAIN_STEPS} steps of B = 1 at "
          f"{cfg.input_size[0]}x{cfg.input_size[1]}, EfficientNet-"
          f"{cfg.backbone_arch} with_cp {cfg.backbone_with_cp}: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}; ms per step "
          f"{statistics.median(times[1:]):.1f} (median of the last "
          f"{N_TRAIN_STEPS - 1}; samples "
          f"{', '.join(f'{t:.1f}' for t in times)}); peak memory {peak:.2f} GiB; launches {launches}", flush=True)
    return launches


def optional_config():
    """The flagship widths with every optional switch of the JAX package
    on: the grid mask, the imgseg head, CRP3D on stage 2's 16x16x2 grid
    (8x8x1 mega-voxels) and the point branch."""
    from stereoscene_torch.models.detector import DetectorConfig

    return DetectorConfig(use_grid_mask=True, imgseg=True, crp3d=True,
                          crp_mega_shape=(8, 8, 1), supervise_points=True)


def every_term(cfg, **kw):
    """A LossConfig with every optional term on, the KL depth loss."""
    from stereoscene_torch.engine.train import LossConfig

    return LossConfig(downsample=cfg.downsample, dbound=cfg.dbound,
                      voxel_ohem=1.0, voxel_lovasz=1.0, voxel_dice=1.0,
                      voxel_lga=1.0, loss_depth_type="kld",
                      loss_seg_weight=1.0, loss_crp_weight=1.0,
                      loss_point_ce_weight=1.0,
                      loss_point_lovasz_weight=1.0, **kw)


OPTIONAL_TERMS = (
    "loss_voxel_ce_0", "loss_voxel_sem_scal_0", "loss_voxel_geo_scal_0",
    "loss_voxel_ohem_0", "loss_voxel_lovasz_0", "loss_voxel_dice_0",
    "loss_voxel_lga_0", "loss_depth", "loss_imgseg", "loss_rel_ce",
    "loss_point_ce", "loss_point_lovasz")
NEW_PARAMS = ("img_bev_encoder_backbone.cp_mega_voxels.", "imgseg_",
              "pts_bbox_head.point_occ_mlp.")


def optional_batches(cfg, tree: tuple, n: int) -> tuple:
    """``n`` train batches of B = 2 from the tree's train frames, through
    an index built with CBGS and the flagship train pipeline with LiDAR
    depth and the relation labels of stage 2's grid (16, 16, 2). Returns
    (batches, frames before CBGS, frames after)."""
    import stereoscene_torch
    from stereoscene_torch.config import Config
    from stereoscene_torch.data import (
        BatchLoader,
        PipelineConfig,
        SemanticKittiIndex,
        SemanticKittiPipeline,
    )

    root, ann, lidar_root = tree
    conf = Config.fromfile(os.path.join(
        os.path.dirname(stereoscene_torch.__file__), "configs", EVAL_CONFIG))
    dcfg = conf["data_config"]
    kw = dict(data_root=root, ann_file=ann, split="train",
              lidar_root=lidar_root, lidarseg_root=lidar_root, seed=SEED)
    plain = len(SemanticKittiIndex(**kw))
    index = SemanticKittiIndex(cbgs=True, **kw)
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=tuple(dcfg["input_size"]), resize=tuple(dcfg["resize"]),
        rot=tuple(dcfg["rot"]), flip=dcfg["flip"],
        crop_h=tuple(dcfg["crop_h"]), is_train=True, load_lidar_depth=True,
        point_cloud_range=tuple(conf["point_cloud_range"]),
        relation_label_shape=(16, 16, 2)), seed=SEED)
    loader = BatchLoader(index.frames, pipe, batch_size=2, shuffle=True,
                         seed=SEED, num_workers=4)
    if len(loader) == 0:
        raise AssertionError(f"CBGS left {len(index)} frames")
    batches = []
    while len(batches) < n:
        batches.extend(loader)
    return batches[:n], plain, len(index)


def phase_optional(dev, build, card: str, tmp: str, tree: tuple) -> dict:
    """Phase 11: the optional branches and the rest of the training
    recipe at the flagship widths (a-f of the module docstring). Returns
    the launches of its runs (a, e and f)."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.engine.loop import step_generator, to_device
    from stereoscene_torch.models.detector import BEVDepthOccupancy
    from stereoscene_torch.utils.weights import seeded_init_

    cfg = optional_config()
    launches = collections.Counter()

    # (a) training from data: CBGS index, relation labels, every term
    t0 = time.perf_counter()
    batches, n_plain, n_cbgs = optional_batches(cfg, tree, OPTIONAL_STEPS)
    data_s = time.perf_counter() - t0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    model = BEVDepthOccupancy(cfg, device=dev)
    seeded_init_(model, SEED)
    state = train.create_train_state(model, device=dev)
    step = train.make_train_step(every_term(cfg), bf16=True,
                                 debug_grads=True)
    new_grads = {}
    apply = train.apply_gradients

    def record(state, grads):
        if not new_grads:
            for (name, _), g in zip(state.trainable, grads):
                if name.startswith(NEW_PARAMS):
                    new_grads[name] = float(g.abs().max())
        apply(state, grads)

    train.apply_gradients = record
    logs, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    try:
        for batch in batches:
            t0 = time.perf_counter()
            state, out = step(state, to_device(batch, dev),
                              step_generator(SEED, state.step, dev))
            logs.append({k: float(v) for k, v in out.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        train.apply_gradients = apply
    counts = dict(build.launch_counts)
    launches.update(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, out in enumerate(logs):
        missing = [k for k in OPTIONAL_TERMS if k not in out]
        if missing or not all(math.isfinite(v) for v in out.values()):
            raise AssertionError(f"phase 11a step {i}: missing {missing} or "
                                 f"non-finite {out}")
        if out["grad_nonfinite"] != 0:
            raise AssertionError(f"phase 11a step {i}: grad_nonfinite "
                                 f"{out['grad_nonfinite']}")
    zero = [n for n, v in new_grads.items() if not v > 0]
    if zero or not all(any(n.startswith(p) for n in new_grads)
                       for p in NEW_PARAMS):
        raise AssertionError(f"phase 11a: zero or missing gradients {zero}")
    if counts.get("gwc_warp", 0) < 1 or counts.get("dcn_gather", 0) < 1:
        raise AssertionError(f"phase 11a: launches {counts}")
    terms = [{k: round(v, 4) for k, v in out.items()} for out in logs]
    largest = {p: max(v for n, v in new_grads.items() if n.startswith(p))
               for p in NEW_PARAMS}
    print(f"phase 11a bf16 training with every switch (grid mask, imgseg, "
          f"CRP3D {cfg.crp_mega_shape}, point branch) and every loss term "
          f"on {card}: {N_TRAIN_FRAMES} train frames, {n_cbgs} after CBGS "
          f"(from {n_plain}); {len(batches)} batches of B = 2 with "
          f"relation labels {tuple(batches[0]['cp_mega_matrix'].shape)} "
          f"(loaded in {data_s:.1f} s); per step {terms}; new parameters' "
          f"largest gradient entries {largest}; "
          f"ms per step {statistics.median(ms[1:]):.1f} (median of the "
          f"last {len(ms) - 1}; samples {', '.join(f'{t:.1f}' for t in ms)}"
          f"); peak memory {peak:.2f} GiB; launches {counts}", flush=True)
    bda_model = model
    del state, step
    torch.cuda.empty_cache()

    # (b) fp32 step with the kernels (K1, P1, K4) and without
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    one = {k: v[:1] for k, v in batches[0].items()}
    runs = []
    for kernels in (True, False):
        m = BEVDepthOccupancy(cfg, device=dev, conv3d_kernel=kernels)
        seeded_init_(m, SEED)
        st = train.create_train_state(m, device=dev)
        build.launch_counts.clear()
        total, losses, grads = train.loss_and_grads(
            st, to_device(one, dev), every_term(cfg), use_kernel=kernels,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        runs.append((total, losses, grads, dict(build.launch_counts),
                     [n for n, _ in st.trainable]))
        del m, st
    (tk, lk, gk, ck, names), (tp, lp, gp, cp, _) = runs
    if (ck.get("gwc_warp") != 1 or ck.get("dcn_gather") != 1
            or ck.get("conv3d_s1", 0) < 12 or cp):
        raise AssertionError(f"phase 11b launches: kernels {ck}, plain {cp}")
    off = {k: (float(lk[k]), float(lp[k])) for k in lp
           if not abs(float(lk[k] - lp[k])) <= 1e-4 * abs(float(lp[k]))}
    if off or not torch.isfinite(tk):
        raise AssertionError(f"phase 11b loss terms off: {off}")
    scale = max(float(g.abs().max()) for g in gp)
    bad = []
    for name, a, b in zip(names, gk, gp):
        leaf = max(float(a.abs().max()), float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= max(2e-2 * leaf, 1e-4 * scale)):
            bad.append((name, err / leaf))
    if bad:
        worst = sorted(bad, key=lambda b: -b[1])[:5]
        raise AssertionError(f"phase 11b: {len(bad)} of {len(names)} grad "
                             f"leaves off, worst {worst}")
    print(f"phase 11b fp32 step with every switch and term, kernels (K1, "
          f"P1, K4) vs plain, B = 1: loss {float(tk):.6f} vs "
          f"{float(tp):.6f}, every term within 1e-4 relative; "
          f"{len(names)} grad leaves within 2% (floor "
          f"{1e-4 * scale:.2e}); launches {ck}", flush=True)
    del runs, gk, gp

    # (c) streaming against the full upsample, fp32, flagship logits
    gen = torch.Generator(device=dev).manual_seed(SEED)
    logits0 = torch.randn((2,) + cfg.grid_shape + (cfg.out_channel,),
                          generator=gen, device=dev) * 2
    gt = torch.as_tensor(batches[0]["gt_occ"]).to(dev)
    found = {}
    for chunks in (8, 0):
        logits = logits0.clone().requires_grad_()
        lc = train.LossConfig(stream_voxel_chunks=chunks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = train.compute_losses({"output_voxels": logits},
                                      {"gt_occ": gt}, lc)
        (grad,) = torch.autograd.grad(sum(losses.values()), logits)
        torch.cuda.synchronize()
        found[chunks] = ({k: float(v) for k, v in losses.items()}, grad,
                         (torch.cuda.max_memory_allocated() - base) / 2**30)
    (ls, gs, ps), (lf, gf, pf) = found[8], found[0]
    off = {k: (ls[k], lf[k]) for k in lf
           if not abs(ls[k] - lf[k]) <= 1e-5 * abs(lf[k])}
    gerr = float((gs - gf).abs().max() / gf.abs().max())
    if off or len(ls) != 3 or not gerr <= 1e-5:
        raise AssertionError(f"phase 11c streaming vs full: {off}, "
                             f"gradient {gerr:.2e}")
    print(f"phase 11c streaming losses (8 Y-slabs) vs the full upsample, "
          f"fp32 logits {tuple(logits0.shape)} against labels "
          f"{tuple(gt.shape)}: {ls} vs {lf}; gradient within {gerr:.2e} "
          f"of its scale; peak memory above the inputs {ps:.3f} GiB "
          f"streaming, {pf:.3f} GiB full", flush=True)
    del found, gs, gf, logits0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.deterministic = False

    # (d) BDA: the pipeline's 4x4 matrix and rotated labels; the detector
    # refuses the 33-wide camera vector, as the JAX package's does
    phase_bda(cfg, tree, bda_model, dev)
    del bda_model, model
    torch.cuda.empty_cache()

    # (e) the burn-in tool
    from stereoscene_torch.tools import train_burnin

    build.launch_counts.clear()
    t0 = time.perf_counter()
    summary = train_burnin.main(["--device", dev.type])
    burnin_s = time.perf_counter() - t0
    launches.update(build.launch_counts)
    if not summary["ok"]:
        raise AssertionError(f"phase 11e burn-in: {summary['checks']}")
    print(f"phase 11e burn-in (stereoscene_torch/tools/train_burnin.py, "
          f"{summary['steps']} bf16 steps of the flagship at B = 1, lr "
          f"{summary['lr']}) on {card}: checks {summary['checks']}; loss "
          f"{summary['loss_first']:.4f} -> {summary['loss_last']:.4f} "
          f"(first 10 mean {summary['loss_first10_mean']:.4f}, last 10 "
          f"{summary['loss_last10_mean']:.4f}); grad norm "
          f"{summary['grad_norm_first']:.3f} -> "
          f"{summary['grad_norm_last']:.3f}; ms per step "
          f"{summary['step_ms']:.1f}; whole run {burnin_s:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    # (f) the train CLI with the grid mask and the OHEM and Lovasz terms
    launches.update(phase_optional_cli(dev, build, card, tmp, tree))
    return dict(launches)


def phase_bda(cfg, tree: tuple, model, dev) -> None:
    """Phase 11d (see ``phase_optional``)."""
    import stereoscene_torch
    from stereoscene_torch.config import Config
    from stereoscene_torch.data import (
        PipelineConfig,
        SemanticKittiIndex,
        SemanticKittiPipeline,
    )
    from stereoscene_torch.engine.loop import to_device

    root, ann, _ = tree
    conf = Config.fromfile(os.path.join(
        os.path.dirname(stereoscene_torch.__file__), "configs", EVAL_CONFIG))
    dcfg = conf["data_config"]
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=tuple(dcfg["input_size"]), is_train=True, apply_bda=True,
        point_cloud_range=tuple(conf["point_cloud_range"])), seed=SEED)
    frames = SemanticKittiIndex(root, ann, "train").frames
    shares = []
    for i, frame in enumerate(frames):
        sample = pipe(frame, seed=SEED + i)
        raw = np.load(frame.voxel_path)
        bda = sample["bda"]
        angle = math.degrees(math.atan2(bda[1, 0], abs(bda[0, 0])))
        if bda.shape != (4, 4) or sample["gt_occ"].shape != raw.shape:
            raise AssertionError(f"phase 11d: bda {bda.shape}, gt_occ "
                                 f"{sample['gt_occ'].shape}")
        shares.append((round(angle, 2), float((raw == 255).mean()),
                       float((sample["gt_occ"] == 255).mean())))
        if abs(angle) > 1.0 and not shares[-1][2] > shares[-1][1]:
            raise AssertionError(f"phase 11d: 255 share {shares[-1]}")
    batch = to_device({k: np.asarray(v)[None] for k, v in sample.items()},
                      dev)
    model.eval()
    try:
        model(batch)
    except ValueError as err:
        refusal = str(err)
    else:
        raise AssertionError("phase 11d: the detector took a 4x4 bda")
    if "33" not in refusal:
        raise AssertionError(f"phase 11d: refusal {refusal!r}")
    print(f"phase 11d BDA on {len(frames)} train frames: bda 4x4, gt_occ "
          f"{tuple(sample['gt_occ'].shape)}; (rotation deg, 255 share "
          f"before, after) {shares}; the detector refuses the batch: "
          f"{refusal!r}", flush=True)


def phase_optional_cli(dev, build, card: str, tmp: str, tree: tuple) -> dict:
    """Phase 11f: the train CLI on the flagship config with
    ``model.use_grid_mask=True`` and the OHEM and Lovasz voxel terms, B = 1
    in bf16 over two train frames (one epoch: two steps). Returns its
    launches."""
    import stereoscene_torch
    from stereoscene_torch.tools import train as train_cli

    root, ann, lidar_root = tree
    # a tree of the first two train frames, linked to the phase 8-9 tree
    sub = os.path.join(tmp, "two_frames")
    seq = os.path.join(sub, "dataset", "sequences", "00")
    src = os.path.join(root, "dataset", "sequences", "00")
    os.makedirs(os.path.join(sub, "labels", "00"))
    os.makedirs(seq)
    os.symlink(os.path.join(src, "calib.txt"), os.path.join(seq, "calib.txt"))
    for fid in ("000000", "000001"):
        for d, ext in (("image_2", ".png"), ("image_3", ".png"),
                       ("voxels", ".bin"), ("velodyne", ".bin"),
                       ("labels", ".label")):
            os.makedirs(os.path.join(seq, d), exist_ok=True)
            os.symlink(os.path.join(src, d, fid + ext),
                       os.path.join(seq, d, fid + ext))
        os.symlink(os.path.join(ann, "00", f"{fid}_1_1.npy"),
                   os.path.join(sub, "labels", "00", f"{fid}_1_1.npy"))
    config = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                          "configs", EVAL_CONFIG)
    loss_w = "model.pts_bbox_head.semkitti_loss_weight_cfg"
    lidar = os.path.join(sub, "dataset", "sequences")
    steps = []
    work_dir = os.path.join(tmp, "train_cli_optional")
    build.launch_counts.clear()
    train_cli.main(
        [config, "--work-dir", work_dir, "--device", dev.type, "--bf16",
         "--batch-size", "1", "--max-epochs", "1", "--deterministic-data",
         "--cfg-options", f"data.train.data_root={sub}",
         f"data.train.ann_file={os.path.join(sub, 'labels')}",
         f"lidar_root={lidar}", f"lidarseg_root={lidar}",
         "model.use_grid_mask=True", f"{loss_w}.voxel_ohem=1.0",
         f"{loss_w}.voxel_lovasz=1.0"],
        hooks=[lambda state, epoch, it, logs: steps.append(
            (state.model.cfg.use_grid_mask,
             {k: float(v) for k, v in logs.items()}))])
    launches = dict(build.launch_counts)
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    logged = [r for r in logged if "loss_total" in r]
    if (len(steps) != 2 or not all(g for g, _ in steps) or not logged
            or not all(k in logged[0] for k in ("loss_voxel_ohem_0",
                                                "loss_voxel_lovasz_0"))
            or not all(math.isfinite(v) for _, s in steps
                       for v in s.values())):
        raise AssertionError(f"phase 11f: steps {steps}, log {logged}")
    print(f"phase 11f train CLI on {card} ({EVAL_CONFIG}, "
          f"--cfg-options model.use_grid_mask=True {loss_w}.voxel_ohem=1.0 "
          f"{loss_w}.voxel_lovasz=1.0), 2 bf16 steps of B = 1: losses "
          f"{[{k: round(v, 4) for k, v in s.items()} for _, s in steps]}; "
          f"train_log.jsonl's first record holds "
          f"{sorted(k for k in logged[0] if k.startswith('loss'))}; "
          f"launches {launches}", flush=True)
    return launches


def bevocc_inputs(h: int, w: int, seed: int, b: int = 1) -> tuple:
    """BEVOcc_kitti's inputs at the flagship calibration: the left eye
    [b, 1, h, w, 3] (seeded) and lidar2img [b, 1, 3, 4] = P @ Tr, P the
    flagship's pinhole (fx = fy = FX, the principal point at the centre)
    and Tr the ego -> camera transform of its cam-to-ego rotation."""
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.randn(b, 1, h, w, 3, generator=gen)
    p = torch.tensor([[FX, 0.0, w / 2.0, 0.0], [0.0, FX, h / 2.0, 0.0],
                      [0.0, 0.0, 1.0, 0.0]])
    rot = torch.tensor([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]])
    tr = torch.eye(4)
    tr[:3, :3] = rot.T
    return imgs, (p @ tr).expand(b, 1, 3, 4).clone()


def card_vs_cpu(name: str, fn, module, args, dev, tol: float = 1e-3):
    """``fn(module, *args)`` on the CPU and on the card (a copy of the
    module), fp32 with TF32 off: every output within ``tol`` of its
    max|ref|. Returns the worst ratio."""
    import copy

    def leaves(out):
        if torch.is_tensor(out):
            return [out]
        if isinstance(out, dict):
            out = list(out.values())
        return [t for o in out for t in leaves(o)] if out is not None else []

    with torch.no_grad():
        want = leaves(fn(module.eval(), *args))
        card = copy.deepcopy(module).to(dev).eval()
        got = leaves(fn(card, *(a.to(dev) if torch.is_tensor(a) else a
                                for a in args)))
    worst = 0.0
    for g, w in zip(got, want):
        ref = float(w.abs().max())
        err = max_err(g.cpu(), w) / max(ref, 1e-12)
        if g.shape != w.shape or not err <= tol:
            raise AssertionError(f"phase 12c {name}: card vs CPU {err:.2e} "
                                 f"of max|ref| (shape {tuple(g.shape)})")
        worst = max(worst, err)
    del card
    return worst


def phase_bevocc(dev, build, card: str) -> dict:
    """Phase 12: (a) BEVOcc_kitti from its config on the card, (b) the
    flagship's ``bev_with_cp``, (c) DepthNetStereo's P1 route and the other
    variant modules against the CPU. Returns the launches of (b) and
    (c)."""
    from stereoscene_torch.config import Config
    from stereoscene_torch.engine import train
    from stereoscene_torch.models import (
        bev_stereo,
        bevocc,
        necks3d,
        shared_occhead,
        temporal,
        voxel_encoder,
    )
    from stereoscene_torch.models.depth_net import DepthAggregation
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.models.efficientnet import CustomEfficientNet
    from stereoscene_torch.models.vit import ViT
    from stereoscene_torch.models.vovnet import VoVNet
    from stereoscene_torch.utils.weights import seeded_init_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    launches = collections.Counter()

    # (a) BEVOcc_kitti at the config's widths on the flagship left eye
    t_phase = time.perf_counter()
    cfg = Config.fromfile("stereoscene_torch/configs/bevocc_kitti.py")
    h, w = 384, 1280
    cpu_model = bevocc.bevocc_from_config(cfg, device="cpu")
    seeded_init_(cpu_model, SEED)
    model = bevocc.bevocc_from_config(cfg, device=dev)
    model.load_state_dict(cpu_model.state_dict())
    imgs, l2i = bevocc_inputs(h, w, SEED + 30)
    with torch.no_grad():
        want = cpu_model(imgs, l2i)["occ_preds"]
        got = model(imgs.to(dev), l2i.to(dev))["occ_preds"]
        shapes = [tuple(p.shape) for p in got]
        errs = [max_err(g.cpu(), r) / float(r.abs().max())
                for g, r in zip(got, want)]
        if (shapes != [(1, 64, 64, 8, 20), (1, 128, 128, 16, 20)]
                or not max(errs) <= 1e-3):
            raise AssertionError(f"phase 12a BEVOcc: shapes {shapes}, card "
                                 f"vs CPU {errs}")
        frames = [bevocc_inputs(h, w, SEED + 31 + i) for i in range(3)]
        model(*(t.to(dev) for t in frames[0]))  # warm-up
        ms = []
        for fi, fl in frames:
            fi, fl = fi.to(dev), fl.to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(fi, fl)["occ_preds"]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if not all(bool(torch.isfinite(p).all()) for p in out):
                raise AssertionError("phase 12a BEVOcc: non-finite logits")
    del want, got, out
    gen = torch.Generator().manual_seed(SEED + 35)
    occ = torch.randint(0, 20, (1, 128, 128, 16), generator=gen)
    gt = torch.where(torch.rand(occ.shape, generator=gen) < 0.1, 255,
                     occ).to(torch.int32).to(dev)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        losses = bevocc.bevocc_loss(
            model(imgs.to(dev), l2i.to(dev))["occ_preds"], gt)
        opt.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        opt.step()
        step_losses.append({k: float(v.detach())
                            for k, v in losses.items()})
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(v) and k.startswith("loss_occ_")
               for out in step_losses for k, v in out.items()) \
            or len(step_losses[0]) != 2:
        raise AssertionError(f"phase 12a BEVOcc steps: {step_losses}")
    head = model.pts_bbox_head
    print(f"phase 12a BEVOcc_kitti (bevocc_from_config of "
          f"stereoscene_torch/configs/bevocc_kitti.py: {model.backbone}, "
          f"out_indices (5,), neck {model.img_neck.out_features}, embed "
          f"{head.embed_dim}, coarsest {head.bev_shape + (head.num_z,)}, "
          f"fpn_level {head.fpn_level}, "
          f"{head.transformer0.num_layers} encoder layers; "
          f"{sum(p.numel() for p in model.parameters())} parameters) on "
          f"{card}, the flagship left eye {h}x{w}: logits {shapes}, card vs "
          f"CPU {', '.join(f'{e:.2e}' for e in errs)} of max|ref| (fp32, "
          f"TF32 off); fp32 eval forward ms {statistics.median(ms):.1f} "
          f"(median of 3 frames after a warm-up; samples "
          f"{', '.join(f'{t:.1f}' for t in ms)}); 4 fp32 AdamW steps at "
          f"B = 1 on seeded 128x128x16 labels: losses "
          f"{[{k: round(v, 4) for k, v in o.items()} for o in step_losses]}"
          f"; ms per step {statistics.median(step_ms[1:]):.1f} (median of "
          f"the last 3; samples {', '.join(f'{t:.1f}' for t in step_ms)}); "
          f"peak memory {peak:.2f} GiB; {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)
    del model, cpu_model, opt
    torch.cuda.empty_cache()

    # (b) the flagship with bev_with_cp: fp32 B = 1 on/off, bf16 B = 2
    t_phase = time.perf_counter()
    batch = train_batch(DetectorConfig(), SEED + 20, dev)
    loss_cfg = train.LossConfig()
    runs = {}
    for cp in (False, True):
        m = BEVDepthOccupancy(DetectorConfig(bev_with_cp=cp), device=dev)
        seeded_init_(m, SEED)
        st = train.create_train_state(m, device=dev)
        build.launch_counts.clear()
        total, losses, grads = train.loss_and_grads(
            st, batch, loss_cfg,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        counts = dict(build.launch_counts)
        launches.update(counts)
        stats = {k: v.clone() for k, v in m.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        runs[cp] = (total, losses, grads, counts, stats,
                    [n for n, _ in st.trainable])
        del m, st
    (t0_, l0, g0, c0, s0, names), (t1, l1, g1, c1, s1, _) = (runs[False],
                                                             runs[True])
    # the checkpointed run launches K1 and P1 again in its recompute
    if (c0.get("gwc_warp") != 1 or c0.get("dcn_gather") != 1
            or c1.get("gwc_warp", 0) < 2 or c1.get("dcn_gather", 0) < 2):
        raise AssertionError(f"phase 12b launches: off {c0}, on {c1}")
    off = {k: (float(l1[k]), float(v)) for k, v in l0.items()
           if not abs(float(l1[k] - v)) <= 1e-4 * abs(float(v))}
    stat_err = max(max_err(s1[k], v) / max(float(v.abs().max()), 1e-6)
                   for k, v in s0.items())
    scale = max(float(g.abs().max()) for g in g0)
    bad = []
    for name, a, b in zip(names, g1, g0):
        leaf = max(float(a.abs().max()), float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        if not (math.isfinite(err) and err <= max(2e-2 * leaf, 1e-4 * scale)):
            bad.append((name, err / leaf))
    if off or bad or not stat_err <= 1e-4:
        raise AssertionError(f"phase 12b fp32 bev_with_cp on vs off: loss "
                             f"terms {off}, statistics {stat_err:.2e}, "
                             f"{len(bad)} grad leaves off "
                             f"{sorted(bad, key=lambda b: -b[1])[:5]}")
    print(f"phase 12b fp32 step of the flagship at B = 1, bev_with_cp on vs "
          f"off: loss {float(t1):.6f} vs {float(t0_):.6f} (every term "
          f"within 1e-4 relative); {len(s0)} running statistics within "
          f"{stat_err:.2e} of their scale (updated once); {len(names)} grad "
          f"leaves within 2% (floor {1e-4 * scale:.2e}); launches on {c1}, "
          f"off {c0}", flush=True)
    del runs, g0, g1
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    pair = [train_batch(DetectorConfig(), SEED + 20 + i, "cpu")
            for i in range(2)]
    batch2 = {k: torch.cat([a[k], b[k]]).to(dev) for k, a, b in
              ((k, pair[0], pair[1]) for k in pair[0])}
    bf16 = {}
    for cp in (False, True):
        m = BEVDepthOccupancy(DetectorConfig(bev_with_cp=cp), device=dev)
        seeded_init_(m, SEED)
        st = train.create_train_state(m, device=dev)
        step = train.make_train_step(loss_cfg, bf16=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        build.launch_counts.clear()
        ms, totals = [], []
        for i in range(2):
            t0 = time.perf_counter()
            st, logs = step(st, batch2,
                            torch.Generator(device=dev).manual_seed(SEED))
            totals.append(float(logs["loss_total"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        launches.update(build.launch_counts)
        bf16[cp] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**30,
                    torch.cuda.max_memory_allocated() / 2**30, totals)
        if not all(math.isfinite(v) for v in totals):
            raise AssertionError(f"phase 12b bf16 bev_with_cp {cp}: {totals}")
        del m, st, step
        torch.cuda.empty_cache()
    if not bf16[True][2] < bf16[False][2]:
        raise AssertionError(f"phase 12b bf16 peak with bev_with_cp "
                             f"{bf16[True][2]:.2f} GiB, without "
                             f"{bf16[False][2]:.2f} GiB")
    print(f"phase 12b bf16 steps of the flagship at B = 2 on {card}: "
          + "; ".join(
              f"bev_with_cp {cp}: ms per step {v[0][1]:.1f} (first "
              f"{v[0][0]:.1f}), peak {v[2]:.2f} GiB ({v[1]:.2f} GiB above "
              f"the model and batch), losses {v[3]}"
              for cp, v in bf16.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)
    del batch, batch2

    # (c) DepthNetStereo's P1 route; each other module against the CPU
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(SEED + 40)
    stereo = bev_stereo.DepthNetStereo(640, 512, 128, 112, cam_channels=27)
    seeded_init_(stereo, SEED)
    stereo = stereo.to(dev).eval()
    x = torch.randn(1, 640, 48, 160, generator=gen).to(dev)
    cam = torch.randn(1, 27, generator=gen).to(dev)
    with torch.no_grad():
        build.launch_counts.clear()
        got = stereo(x, cam, use_kernel=True)
        counts = dict(build.launch_counts)
        want = stereo(x, cam, use_kernel=False)
    launches.update(counts)
    if counts.get("dcn_gather") != 1:
        raise AssertionError(f"phase 12c DepthNetStereo launches {counts}")
    stereo_err = {k: max_err(got[k], want[k]) / float(want[k].abs().max())
                  for k in want}
    if not max(stereo_err.values()) <= 1e-4:
        raise AssertionError(f"phase 12c DepthNetStereo P1 vs plain: "
                             f"{stereo_err}")
    del stereo, got, want
    checks = {}
    rng = np.random.RandomState(SEED + 41)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    yaw = 0.1
    tf = torch.tensor([[[math.cos(yaw), -math.sin(yaw), 1.3],
                        [math.sin(yaw), math.cos(yaw), -0.7], [0, 0, 1]]])
    dx = np.array([0.8, 0.8, 0.8], np.float32)
    bx = np.array([0.4, -25.2, -1.6], np.float32)
    checks["temporal shift [1, 64, 64, 8, 128]"] = card_vs_cpu(
        "temporal", lambda m, f, a: temporal.shift_voxel_feature(
            f, a, dx, bx), torch.nn.Identity(), (t(1, 64, 64, 8, 128), tf),
        dev)
    agg = DepthAggregation(128, 128, 128)
    seeded_init_(agg, SEED)
    checks["DepthAggregation [2, 128, 160, 112]"] = card_vs_cpu(
        "DepthAggregation", lambda m, v: m(v), agg, (t(2, 128, 160, 112),),
        dev)
    pyramid = (t(1, 128, 64, 64, 8), t(1, 256, 32, 32, 4),
               t(1, 512, 16, 16, 2))
    for name, neck in (
            ("FPN3D", necks3d.FPN3D((128, 256, 512), 128, num_upsample=1)),
            ("SpconvNeck3D", necks3d.SpconvNeck3D((128, 256, 512), 128))):
        seeded_init_(neck, SEED)
        checks[f"{name} (128, 256, 512) at 64x64x8"] = card_vs_cpu(
            name, lambda m, *f: m(list(f)), neck, pyramid, dev)
    shared = shared_occhead.SharedOccHead(128, 20, 128)
    seeded_init_(shared, SEED)
    pts = torch.from_numpy(np.stack(
        [rng.uniform(0, 51.2, (1, 10000)), rng.uniform(-25.6, 25.6,
                                                       (1, 10000)),
         rng.uniform(-2, 4.4, (1, 10000))], -1).astype(np.float32))
    checks["SharedOccHead [1, 128, 128, 16, 128], 10000 points"] = \
        card_vs_cpu("SharedOccHead", lambda m, g, p: m([g], p), shared,
                    (t(1, 128, 128, 16, 128), pts), dev)
    n_pts = N_LIDAR_POINTS
    lidar = torch.from_numpy(np.stack(
        [rng.uniform(-5, 56, n_pts), rng.uniform(-30, 30, n_pts),
         rng.uniform(-3, 5, n_pts)], -1).astype(np.float32))
    pcr = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
    enc = voxel_encoder.DenseSparseEncoder(4)
    unet = voxel_encoder.DenseUNet3D(4)
    for mod in (enc, unet):
        seeded_init_(mod, SEED)

    def encode(m, pts, feats):
        grid = voxel_encoder.voxelize_points(
            pts, feats, torch.ones(len(pts), dtype=torch.bool,
                                   device=pts.device), (128, 128, 16), pcr)
        grid = grid.permute(3, 0, 1, 2)[None]
        return [grid, m[0](grid), m[1](grid)]

    checks[f"voxelize {n_pts} points + DenseSparseEncoder + DenseUNet3D "
           f"at 128x128x16"] = card_vs_cpu(
        "voxel encoder", encode, torch.nn.ModuleList([enc, unet]),
        (lidar, t(n_pts, 4)), dev)
    img = t(1, 3, 384, 1280)
    for name, net in (("ViT-S/16 (embed 384, depth 12)", ViT((384, 1280))),
                      ("VoVNet", VoVNet()),
                      ("EfficientNet-es", CustomEfficientNet(
                          "es", (2, 3, 4, 5, 6)))):
        seeded_init_(net, SEED)
        checks[f"{name} on 384x1280"] = card_vs_cpu(
            name, lambda m, v: m(v), net, (img,), dev)
    print(f"phase 12c DepthNetStereo (in 640, mid 512, context 128, D 112) "
          f"on the 48x160 features: P1 route vs plain "
          f"{', '.join(f'{k} {v:.2e}' for k, v in stereo_err.items())} of "
          f"max|ref| (fp32), launches {counts}; card vs CPU (fp32, TF32 "
          f"off, within 1e-3 of max|ref|): "
          f"{'; '.join(f'{k} {v:.2e}' for k, v in checks.items())}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    return dict(launches)


def nusc_frames() -> list:
    """(scene token, can_bus [18]) of four frames: three of one scene,
    the ego 2 m forward and 3 degrees left a frame (position in [0:3], yaw
    in radians at [-2] and degrees at [-1], as mmdet3d's infos hold them),
    then the first frame of another scene."""
    frames = []
    for i in range(4):
        bus = np.zeros(18, np.float32)
        yaw = 3.0 * i
        bus[:3] = [2.0 * i, 0.1 * i * i, 0.0]
        bus[-2], bus[-1] = np.deg2rad(yaw), yaw
        frames.append(("scene-0001" if i < 3 else "scene-0002", bus))
    frames[3][1][:3] = [600.0, 1600.0, 0.0]
    return frames


def write_nuscenes_infos(root: str, frames: list, seed: int) -> str:
    """An mmdet3d-style info pickle of ``frames`` under ``root``: six
    seeded 900x1600 JPEGs (shared by the frames), each camera at its
    nuScenes heading 1.5 m above the ego origin with nuScenes' front-camera
    intrinsics (scaled to ``NUSC_IMAGE``). Returns the pickle's path."""
    import pickle

    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    sy, sx = NUSC_IMAGE[0] / 900.0, NUSC_IMAGE[1] / 1600.0
    intrinsic = np.array([[1266.4 * sx, 0.0, 816.3 * sx],
                          [0.0, 1266.4 * sx, 491.5 * sy], [0.0, 0.0, 1.0]])
    cams = {}
    for cam, heading in NUSC_HEADINGS.items():
        path = os.path.join(root, f"{cam}.jpg")
        Image.fromarray(rng.randint(0, 255, NUSC_IMAGE + (3,),
                                    np.uint8)).save(path)
        th = np.deg2rad(heading)
        # camera axes (x right, y down, z forward) in the lidar frame
        rot = np.array([[np.sin(th), 0.0, np.cos(th)],
                        [-np.cos(th), 0.0, np.sin(th)], [0.0, -1.0, 0.0]])
        cams[cam] = {"data_path": path,
                     "cam_intrinsic": intrinsic,
                     "sensor2lidar_rotation": rot,
                     "sensor2lidar_translation": np.array(
                         [0.5 * np.cos(th), 0.5 * np.sin(th), 1.5])}
    infos = [{"token": f"sample-{i}", "scene_token": scene, "can_bus": bus,
              "cams": cams} for i, (scene, bus) in enumerate(frames)]
    path = os.path.join(root, "nuscenes_infos.pkl")
    with open(path, "wb") as f:
        pickle.dump({"infos": infos}, f)
    return path


def nusc_lidar2img(sample: dict) -> np.ndarray:
    """[N_cam, 3, 4] lidar -> augmented-image projections of a
    ``NuScenesPipeline`` sample: post homography @ K @ [R^T | -R^T t]."""
    out = []
    for rot, tran, k, pr, pt in zip(sample["rots"], sample["trans"],
                                    sample["intrins"], sample["post_rots"],
                                    sample["post_trans"]):
        l2c = np.concatenate([rot.T, -(rot.T @ tran)[:, None]], 1)
        post = np.eye(3, dtype=np.float32)
        post[:2, :2] = pr[:2, :2]
        post[:2, 2] = pt[:2]
        out.append(post @ k @ l2c)
    return np.stack(out).astype(np.float32)


def nusc_scene(model, inputs: tuple, n: int) -> list:
    """Frames 0..n-1 of ``inputs`` (index, features, spatial shapes,
    lidar2img) through ``PrevFrameInfo`` on ``model``'s device: (outputs,
    host ms to a synchronised end, prev_bev given, can_bus deltas) per
    frame."""
    from stereoscene_torch.models.bevformer_det import PrevFrameInfo

    index, feats, shapes, l2i = inputs
    device = next(model.parameters()).device
    state = PrevFrameInfo()
    runs = []
    for i in range(n):
        prev, bus = state.step(index[i]["scene_token"], index[i]["can_bus"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(feats[i].to(device), shapes, l2i[i].to(device),
                    NUSC_INPUT, prev_bev=prev,
                    can_bus=torch.from_numpy(bus)[None].to(device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs.append((out, (time.perf_counter() - t0) * 1e3,
                     prev is not None, bus))
        state.update(out["bev_embed"])
    return runs


def scene_errors(cpu_model, model, inputs: tuple, n: int) -> dict:
    """Each output of ``n`` frames through ``nusc_scene`` on the card
    against the CPU, as a share of its max|ref|."""
    errs = {}
    for fi, ((g, *_), (w, *_)) in enumerate(zip(
            nusc_scene(model, inputs, n), nusc_scene(cpu_model, inputs, n))):
        for key in ("all_cls_scores", "all_bbox_preds", "bev_embed"):
            errs[f"frame {fi} {key}"] = (max_err(g[key].cpu(), w[key])
                                         / float(w[key].abs().max()))
    return errs


def phase_nuscenes(dev, build, card: str) -> dict:
    """Phase 13: (a) BEVFormer-tiny from NuScenesPipeline samples on the
    card (against the CPU, the temporal eval, training with a history
    queue, decoding and scoring), (b) the Mask2Former occupancy head at the
    JAX defaults (against the CPU at 50x50x4; forward and training at
    200x200x16), (c) ``batched_nms`` and ``decode_nms_free`` against the
    CPU. The head's deformable attention takes its kernel under no-grad and
    the plain gathers in training; returns the launches counted in it."""
    from stereoscene_torch.core import bbox3d
    from stereoscene_torch.core.nuscenes_eval import (
        DETECTION_CLASSES,
        boxes_from_arrays,
        evaluate_detections,
    )
    from stereoscene_torch.data.nuscenes import (
        NuScenesIndex,
        NuScenesPipeline,
    )
    from stereoscene_torch.data.pipeline import PipelineConfig
    from stereoscene_torch.models import bevformer_det, mask2former_occ
    from stereoscene_torch.ops.resize import resize_trilinear
    from stereoscene_torch.utils.weights import seeded_init_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build.launch_counts.clear()
    stats = mask2former_occ.MATCH_STATS

    # (a) BEVFormer-tiny on NuScenesPipeline samples
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        index = NuScenesIndex(write_nuscenes_infos(tmp, nusc_frames(),
                                                   SEED + 50))
        pipe = NuScenesPipeline(PipelineConfig(input_size=NUSC_INPUT),
                                seed=SEED)
        samples, host_ms = [], []
        for i in range(len(index)):
            t0 = time.perf_counter()
            samples.append(pipe(index[i]))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    if samples[0]["imgs"].shape != (6,) + NUSC_INPUT + (3,):
        raise AssertionError(f"phase 13a pipeline imgs "
                             f"{samples[0]['imgs'].shape}")
    l2i = [torch.from_numpy(nusc_lidar2img(s))[None] for s in samples]
    gen = torch.Generator().manual_seed(SEED + 51)
    fh, fw, fc = NUSC_FEAT
    feats = [torch.randn(1, 6, fh * fw, fc, generator=gen) for _ in samples]
    shapes = [(fh, fw)]
    cpu_model = bevformer_det.BEVFormerDetector(
        fc, can_bus=True, device="cpu", **BEVFORMER_TINY).eval()
    seeded_init_(cpu_model, SEED)
    model = bevformer_det.BEVFormerDetector(
        fc, can_bus=True, device=dev, **BEVFORMER_TINY).eval()
    model.load_state_dict(cpu_model.state_dict())
    scene_inputs = (index, feats, shapes, l2i)
    with torch.no_grad():
        plain_errs = scene_errors(cpu_model, model, scene_inputs, 2)
        # the layers that steer the sampling (offsets, attention weights)
        # and the box and class outputs scaled down: a refinement step then
        # moves the references a little, as a trained head's does; at
        # seeded_init_'s scale the six refining decoder layers amplify fp32
        # rounding past any tolerance, which the line prints and does not
        # hold
        for m in (cpu_model, model):
            for name, p in m.named_parameters():
                if name.endswith(STEERING):
                    p.mul_(STEERING_SCALE)
    _, seen = model.bev_encoder.project(l2i[0].to(dev), NUSC_INPUT)
    seen = seen.any(-1).float().mean(-1)[0].tolist()  # BEV share per camera
    if not min(seen) > 0:
        raise AssertionError(f"phase 13a: a camera sees no BEV cell {seen}")

    with torch.no_grad():
        errs = scene_errors(cpu_model, model, scene_inputs, 2)
        if not max(errs.values()) <= 1e-3:
            raise AssertionError(f"phase 13a BEVFormer card vs CPU: {errs}")
        runs = nusc_scene(model, scene_inputs, 4)
    eval_ms = [r[1] for r in runs]
    if [r[2] for r in runs] != [False, True, True, False] \
            or runs[3][3][:3].any() or runs[3][3][-1] != 0:
        raise AssertionError("phase 13a PrevFrameInfo: the new scene did "
                             "not reset the history")
    out0 = runs[0][0]
    dims = (tuple(out0["all_cls_scores"].shape),
            tuple(out0["all_bbox_preds"].shape),
            tuple(out0["bev_embed"].shape))
    del runs, out0

    rng = np.random.RandomState(SEED + 52)
    n_gt = NUSC_GT_BOXES
    gt_boxes = np.concatenate([
        rng.uniform(-45, 45, (1, n_gt, 2)), rng.uniform(-3, 1, (1, n_gt, 1)),
        rng.uniform(0.5, 5, (1, n_gt, 3)),
        rng.uniform(-np.pi, np.pi, (1, n_gt, 1)),
        rng.uniform(-5, 5, (1, n_gt, 2))], -1).astype(np.float32)
    gt_labels = rng.randint(0, 10, (1, n_gt)).astype(np.int64)
    gt = (torch.from_numpy(gt_boxes).to(dev),
          torch.from_numpy(gt_labels).to(dev),
          torch.ones(1, n_gt, dtype=torch.bool, device=dev))
    state = bevformer_det.PrevFrameInfo()
    bus = [torch.from_numpy(state.step(index[i]["scene_token"],
                                       index[i]["can_bus"])[1])
           for i in range(3)]
    featsq = torch.stack(feats[:2], 1).to(dev)
    l2iq = torch.stack(l2i[:2], 1).to(dev)
    busq = torch.stack(bus[:2])[None].to(dev)
    cur = (feats[2].to(dev), shapes, l2i[2].to(dev), NUSC_INPUT)
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=2e-4, weight_decay=0.01)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_losses, match = [], [], []
    for _ in range(4):
        before = dict(stats)
        t0 = time.perf_counter()
        hist = bevformer_det.obtain_history_bev(
            model, featsq, shapes, l2iq, NUSC_INPUT, can_bus_queue=busq,
            prev_bev_exists=[True, True])
        out = model(*cur, prev_bev=hist, can_bus=bus[2][None].to(dev))
        losses = bevformer_det.bevformer_detection_loss(out, *gt)
        opt.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        opt.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_losses.append({k: float(v.detach()) for k, v in losses.items()})
        match.append((stats["calls"] - before["calls"],
                      (stats["copy_s"] - before["copy_s"]) * 1e3,
                      (stats["solve_s"] - before["solve_s"]) * 1e3))
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    n_dec = BEVFORMER_TINY["num_decoder_layers"]
    if any(len(s) != 2 * n_dec or not all(math.isfinite(v)
                                          for v in s.values())
           for s in step_losses) or any(m[0] != n_dec for m in match):
        raise AssertionError(f"phase 13a steps: {step_losses}, matchings "
                             f"{match}")
    model.eval()
    with torch.no_grad():
        hist = bevformer_det.obtain_history_bev(
            model, featsq, shapes, l2iq, NUSC_INPUT, can_bus_queue=busq)
        out = model(*cur, prev_bev=hist, can_bus=bus[2][None].to(dev))
        dec = bevformer_det.bevformer_get_bboxes(out, max_num=300)
    t0 = time.perf_counter()
    gts = boxes_from_arrays(["sample-2"] * n_gt, gt_boxes[0], gt_labels[0],
                            classes=DETECTION_CLASSES)
    preds = boxes_from_arrays(
        ["sample-2"] * 300, dec["boxes"][0].cpu().numpy(),
        dec["labels"][0].cpu().numpy(), dec["scores"][0].cpu().numpy(),
        classes=DETECTION_CLASSES)
    metrics = evaluate_detections(gts, preds)
    score_ms = (time.perf_counter() - t0) * 1e3
    if not (0.0 <= metrics.mean_ap <= 1.0 and 0.0 <= metrics.nd_score <= 1.0):
        raise AssertionError(f"phase 13a scoring: mAP {metrics.mean_ap}, "
                             f"NDS {metrics.nd_score}")
    print(f"phase 13a BEVFormer-tiny widths ({BEVFORMER_TINY}; "
          f"{sum(p.numel() for p in model.parameters())} parameters) on "
          f"{card}: NuScenesPipeline at {NUSC_INPUT[0]}x{NUSC_INPUT[1]} of "
          f"six {NUSC_IMAGE[0]}x{NUSC_IMAGE[1]} JPEGs, host ms per sample "
          f"{statistics.median(host_ms):.1f} (samples "
          f"{', '.join(f'{t:.1f}' for t in host_ms)}); share of the BEV "
          f"each camera sees {', '.join(f'{v:.3f}' for v in seen)}; "
          f"seeded features {fh}x{fw}x{fc}; outputs {dims}; card vs CPU "
          f"(fp32, TF32 off, 2 frames, the second with prev_bev and "
          f"can_bus; sampling-offset, attention-weight and box/class output "
          f"layers at {STEERING_SCALE}x seeded_init_): "
          f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} of "
          f"max|ref| (at 1x, not held: "
          f"{', '.join(f'{v:.2e}' for v in plain_errs.values())}); fp32 "
          f"eval forward ms through PrevFrameInfo "
          f"{statistics.median(eval_ms[:3]):.1f} (median of the scene's 3 "
          f"frames; samples {', '.join(f'{t:.1f}' for t in eval_ms)}; "
          f"frame 4, a new scene, reset the history); 4 fp32 AdamW steps at "
          f"B = 1, each with a 2-frame history and {n_gt} seeded boxes: ms "
          f"per step {statistics.median(step_ms[1:]):.1f} (median of the "
          f"last 3; samples {', '.join(f'{t:.1f}' for t in step_ms)}), peak "
          f"{train_peak:.2f} GiB, Hungarian matchings a step "
          f"{match[-1][0]}: copy to host (waits for the forward) ms "
          f"{', '.join(f'{m[1]:.2f}' for m in match)}, scipy ms "
          f"{', '.join(f'{m[2]:.2f}' for m in match)}; losses first "
          f"{ {k: round(v, 4) for k, v in step_losses[0].items()} }, last "
          f"{ {k: round(v, 4) for k, v in step_losses[-1].items()} }; "
          f"bevformer_get_bboxes (300) + evaluate_detections ({score_ms:.1f}"
          f" host ms): mAP {metrics.mean_ap:.4f}, NDS "
          f"{metrics.nd_score:.4f}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del model, cpu_model, opt, out, hist, featsq
    torch.cuda.empty_cache()

    # (b) the Mask2Former occupancy head at the JAX defaults
    t_phase = time.perf_counter()
    cpu_head = mask2former_occ.Mask2FormerOccHead(
        M2F_IN, device="cpu", **MASK2FORMER).eval()
    seeded_init_(cpu_head, SEED)
    head = mask2former_occ.Mask2FormerOccHead(
        M2F_IN, device=dev, **MASK2FORMER).eval()
    head.load_state_dict(cpu_head.state_dict())
    n_layers = MASK2FORMER["num_layers"]

    def with_masks(m, x):
        masks = []
        hooks = [getattr(m, f"layer{i}").cross_attn.register_forward_pre_hook(
            lambda mod, args: masks.append(args[-1].cpu()))
            for i in range(n_layers)]
        out = m(x)
        for h in hooks:
            h.remove()
        return out, masks

    x_small = torch.randn(1, *M2F_SMALL, M2F_IN, generator=gen)
    with torch.no_grad():
        want, wmasks = with_masks(cpu_head, x_small)
        got, gmasks = with_masks(head, x_small.to(dev))
        pairs = [("cls_logits", got["cls_logits"], want["cls_logits"]),
                 ("mask_logits", got["mask_logits"], want["mask_logits"])]
        for i, ((gc, gm), (wc, wm)) in enumerate(zip(got["aux"],
                                                     want["aux"])):
            pairs += [(f"aux{i} cls", gc, wc), (f"aux{i} mask", gm, wm)]
        m2f_errs = {k: max_err(g.cpu(), w) / float(w.abs().max())
                    for k, g, w in pairs}
        half = tuple(n // 2 for n in M2F_SMALL)
        near = 0
        for i, (_, logits) in enumerate(want["aux"]):
            level = (half, M2F_SMALL)[i % 2]
            r = resize_trilinear(logits.reshape(1, -1, *M2F_SMALL, 1), level)
            near += int((r.abs() < 1e-5).sum())
    masks_equal = all(torch.equal(g, w) for g, w in zip(gmasks, wmasks))
    masked = [float(w.float().mean()) for w in wmasks]
    if not max(m2f_errs.values()) <= 1e-3 or not masks_equal \
            or len(gmasks) != n_layers:
        raise AssertionError(f"phase 13b Mask2Former card vs CPU: "
                             f"{m2f_errs}; masks equal {masks_equal}; "
                             f"{near} resampled logits within 1e-5 of 0")
    del cpu_head, want, got

    x = torch.randn(1, *NUSC_OCC, M2F_IN, generator=gen).to(dev)
    n_cls = MASK2FORMER["num_classes"]
    coarse = torch.randint(0, 17, (1,) + tuple(n // 8 for n in NUSC_OCC),
                           generator=gen)
    labels = coarse.repeat_interleave(8, 1).repeat_interleave(
        8, 2).repeat_interleave(8, 3).to(dev)
    classes = torch.arange(n_cls, device=dev)[None]
    tgt_masks = (labels[:, None] == classes[..., None, None, None]).float()
    tgt_valid = tgt_masks.flatten(2).any(-1)
    try:
        with torch.no_grad():
            fwd_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = head(x)
                torch.cuda.synchronize()
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
            sem = mask2former_occ.semantic_inference(out["cls_logits"],
                                                     out["mask_logits"])
            if tuple(sem.shape) != (1,) + NUSC_OCC + (n_cls,) \
                    or not bool(torch.isfinite(sem).all()):
                raise AssertionError(f"phase 13b semantic_inference "
                                     f"{tuple(sem.shape)}")
            del out, sem
        head.train()
        opt = torch.optim.AdamW(head.parameters(), lr=1e-4,
                                weight_decay=0.01)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m2f_ms, m2f_losses = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            # the deformable attention's kernel is forward-only
            losses = mask2former_occ.mask2former_loss_all_layers(
                head(x, use_kernel=False), tgt_masks,
                classes.expand(1, n_cls), tgt_valid)
            opt.zero_grad(set_to_none=True)
            sum(losses.values()).backward()
            opt.step()
            torch.cuda.synchronize()
            m2f_ms.append((time.perf_counter() - t0) * 1e3)
            m2f_losses.append({k: float(v.detach())
                               for k, v in losses.items()})
        m2f_peak = torch.cuda.max_memory_allocated() / 2**30
    except torch.cuda.OutOfMemoryError as exc:
        raise AssertionError(f"phase 13b: the {NUSC_OCC} grid does not fit "
                             f"on {card}: {exc}") from exc
    if any(len(s) != 3 * (n_layers + 1) or not all(math.isfinite(v)
                                                   for v in s.values())
           for s in m2f_losses):
        raise AssertionError(f"phase 13b steps: {m2f_losses}")
    final = {k: round(v, 4) for k, v in m2f_losses[0].items()
             if "aux" not in k}
    print(f"phase 13b Mask2FormerOccHead ({MASK2FORMER}, in {M2F_IN}) on "
          f"{card}: {M2F_SMALL} card vs CPU (fp32, TF32 off) "
          f"{max(m2f_errs.values()):.2e} of max|ref| (worst of "
          f"{len(m2f_errs)} outputs), attention masks equal on "
          f"{n_layers} layers (masked share "
          f"{', '.join(f'{v:.3f}' for v in masked)}), {near} resampled "
          f"mask logits within 1e-5 of 0; {NUSC_OCC}: fp32 forward ms "
          f"{statistics.median(fwd_ms[1:]):.1f} (samples "
          f"{', '.join(f'{t:.1f}' for t in fwd_ms)}), semantic_inference "
          f"[1, {', '.join(map(str, NUSC_OCC))}, {n_cls}]; 2 AdamW steps on "
          f"mask2former_loss_all_layers ({int(tgt_valid.sum())} seeded "
          f"classes): ms per step {', '.join(f'{t:.1f}' for t in m2f_ms)}, "
          f"peak {m2f_peak:.2f} GiB; the last layer's losses at step 1 "
          f"{final}, {len(m2f_losses[0])} terms finite; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del head, opt, x, tgt_masks, labels
    torch.cuda.empty_cache()

    # (c) the box core on the card against the CPU
    rng = np.random.RandomState(SEED + 53)
    lo = rng.uniform(-50, 45, (900, 2))
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + rng.uniform(0.5, 6, (900, 2))], 1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(900).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, 900))
    keep = bbox3d.batched_nms(boxes, scores, labels, 0.5, 300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keep_card = bbox3d.batched_nms(boxes.to(dev), scores.to(dev),
                                   labels.to(dev), 0.5, 300)
    torch.cuda.synchronize()
    nms_ms = (time.perf_counter() - t0) * 1e3
    cls = torch.from_numpy(rng.randn(1, 900, 10).astype(np.float32))
    preds = torch.from_numpy(np.concatenate([
        rng.uniform(-60, 60, (1, 900, 2)), rng.uniform(-5, 3, (1, 900, 1)),
        rng.randn(1, 900, 3),
        rng.randn(1, 900, 2), rng.randn(1, 900, 2)], -1).astype(np.float32))
    dec = bbox3d.decode_nms_free(cls, preds, max_num=300)
    dec_card = bbox3d.decode_nms_free(cls.to(dev), preds.to(dev),
                                      max_num=300)
    # the picks equal; the scores and boxes (sigmoid, exp, atan2 on each
    # device) to fp32 rounding
    dec_equal = {k: torch.equal(dec_card[k].cpu(), dec[k])
                 for k in ("labels", "valid")}
    dec_err = {k: max_err(dec_card[k].cpu(), dec[k])
               / float(dec[k].abs().max()) for k in ("scores", "boxes")}
    if not torch.equal(keep_card.cpu(), keep) or not all(dec_equal.values()) \
            or not max(dec_err.values()) <= 1e-6:
        raise AssertionError(f"phase 13c: batched_nms equal "
                             f"{torch.equal(keep_card.cpu(), keep)}, "
                             f"decode_nms_free {dec_equal}, {dec_err}")
    launches = dict(build.launch_counts)
    print(f"phase 13c batched_nms on 900 seeded boxes (10 classes, IoU 0.5, "
          f"max 300) on {card}: keep mask bitwise equal to the CPU "
          f"({int(keep.sum())} kept; {nms_ms:.1f} ms); decode_nms_free "
          f"[1, 900, 10] -> 300: labels and the in-range mask equal to the "
          f"CPU's ({int(dec['valid'].sum())} in range), scores and boxes "
          f"within {', '.join(f'{v:.2e}' for v in dec_err.values())} of "
          f"max|ref| (1e-6 held); phase 13 kernel launches {launches}; "
          f"phase 13 {time.perf_counter() - t_start:.1f} s", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    return launches


def highres_batch(cfg, label_shape, b: int, seed: int, dev) -> dict:
    """``b`` flagship frames (seeded images, one calibration) with seeded
    labels [b, *label_shape] in [0, 20) with 10% ignore (255), and a
    sparse LiDAR-like gt_depth [b, 1, H, W] (7% of pixels)."""
    gen = torch.Generator().manual_seed(seed)
    frames = [_frames.frame(cfg, "cpu", seed + i) for i in range(b)]
    batch = {k: torch.cat([f[k] for f in frames]) for k in frames[0]}
    occ = torch.randint(0, 20, (b,) + tuple(label_shape), generator=gen)
    ignore = torch.rand(occ.shape, generator=gen) < 0.1
    batch["gt_occ"] = torch.where(ignore, 255, occ).to(torch.int32)
    h, w = cfg.input_size
    hit = torch.rand(b, 1, h, w, generator=gen) < 0.07
    lo, hi, _ = cfg.dbound
    depth = lo + (hi - lo) * torch.rand(b, 1, h, w, generator=gen)
    batch["gt_depth"] = depth * hit
    return {k: v.to(dev) for k, v in batch.items()}


def highres_setup():
    """(the highres config's DetectorConfig with ``bev_with_cp``, its label
    shape, the train CLI's LossConfig for it)."""
    import dataclasses

    import stereoscene_torch
    from stereoscene_torch.config import Config
    from stereoscene_torch.models.detector import DetectorConfig
    from stereoscene_torch.tools.train import loss_config

    cfg = Config.fromfile(os.path.join(os.path.dirname(
        stereoscene_torch.__file__), "configs", HIGHRES_CONFIG))
    det = dataclasses.replace(DetectorConfig.from_config(cfg),
                              bev_with_cp=True)
    return det, tuple(cfg["occ_size"]), loss_config(cfg, det)


def recorded_step(train, loss_cfg, state, batch, generator):
    """One fp32 train step (``make_train_step``); -> (logs, the gradients
    it applied, after the reduction over ranks, by parameter name)."""
    applied = []
    apply = train.apply_gradients

    def record(state, grads):
        applied.append([g.detach().cpu() for g in grads])
        apply(state, grads)

    train.apply_gradients = record
    try:
        _, logs = train.make_train_step(loss_cfg)(state, batch, generator)
    finally:
        train.apply_gradients = apply
    return ({k: float(v) for k, v in logs.items()},
            dict(zip([n for n, _ in state.trainable], applied[0])))


def branches_setup():
    """(the flagship DetectorConfig with CRP3D on stage 2's 16x16x2 grid
    (8x8x1 mega-voxels) and the point branch, its label shape, a LossConfig
    with the OHEM, dice and LGA voxel terms, the CRP relation loss and the
    point CE and Lovasz terms beside ce, sem_scal, geo_scal and the BCE
    depth loss, no streaming)."""
    from stereoscene_torch.engine.train import LossConfig
    from stereoscene_torch.models.detector import DetectorConfig

    det = DetectorConfig(crp3d=True, crp_mega_shape=(8, 8, 1),
                         supervise_points=True)
    return det, LABEL_SHAPE, LossConfig(
        voxel_ohem=1.0, voxel_dice=1.0, voxel_lga=1.0, loss_crp_weight=1.0,
        loss_point_ce_weight=1.0, loss_point_lovasz_weight=1.0)


SP_SETUPS = {"highres": highres_setup, "branches": branches_setup}


def sp_rank(rank: int, url: str, setup: str, weights: str, batch_file: str,
            reference: str, out: str) -> None:
    """One rank of phase 14b or 15b, in a spawned process: joins the
    two-rank gloo group at ``url`` on the one card laid out as (data 1,
    space 2), takes one fp32 step of the model of ``SP_SETUPS[setup]``
    with K4 on its X slab (TF32 off), holds the gradients it applied
    against the one-process ones in ``reference`` and writes the results
    to ``out`` as JSON."""
    from stereoscene_torch import _build, parallel
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import BEVDepthOccupancy
    from stereoscene_torch.parallel import spatial

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det, label_shape, loss_cfg = SP_SETUPS[setup]()
    dev = parallel.init_distributed(url, 2, rank, "cuda", backend="gloo",
                                    timeout_s=SP_TIMEOUT_S)
    try:
        parallel.init_space(2)
        model = BEVDepthOccupancy(det, conv3d_kernel=True,
                                  label_shape=label_shape)
        model.load_state_dict(torch.load(weights, weights_only=True))
        state = train.create_train_state(model)
        batch = {k: v.to(dev) for k, v in
                 torch.load(batch_file, weights_only=True).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launch_counts.clear()
        halo0 = dict(spatial.HALO_STATS)
        t0 = time.perf_counter()
        logs, grads = recorded_step(
            train, loss_cfg, state, batch,
            torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = dict(_build.launch_counts)
        halo = {k: spatial.HALO_STATS[k] - halo0[k] for k in halo0}
        digest = param_digest(state.model)
    finally:
        parallel.shutdown()
    ref = torch.load(reference, weights_only=True)
    scale = max(float(g.abs().max()) for g in ref["grads"].values())
    bad, worst = [], 0.0
    for name, want in ref["grads"].items():
        got = grads[name]
        leaf = max(float(want.abs().max()), float(got.abs().max()), 1e-6)
        err = float((got - want).abs().max())
        worst = max(worst, err / leaf)
        if not (math.isfinite(err) and err <= max(2e-2 * leaf,
                                                  1e-4 * scale)):
            bad.append((name, err / leaf))
    with open(out, "w") as f:
        json.dump(dict(logs=logs, ref_logs=ref["logs"], step_ms=step_ms,
                       peak=peak, launches=launches, halo=halo,
                       digest=digest, bad=bad, leaves=len(ref["grads"]),
                       worst=worst, floor=1e-4 * scale), f)


def sharded_step(setup: str, batch: dict, tmp: str, build,
                 tag: str) -> dict:
    """One fp32 step (TF32 off) of ``SP_SETUPS[setup]``'s model with K4 on
    seeded weights and ``batch`` in one process, then on two gloo ranks
    spawned on the one card at (data 1, space 2) (``sp_rank``): every loss
    term within 1e-4 relative of one process's, both ranks' terms and
    parameter digests equal, every gradient leaf within 2% (floor 1e-4 of
    the global scale), K1, P1 and K4 launched on each rank. Returns the
    ranks' results, the one-process terms, ms and peak, the largest
    relative difference and the launches of all three runs."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import BEVDepthOccupancy
    from stereoscene_torch.utils.weights import seeded_init_

    det, label_shape, loss_cfg = SP_SETUPS[setup]()
    launches = collections.Counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = BEVDepthOccupancy(det, conv3d_kernel=True,
                              label_shape=label_shape)
    seeded_init_(model, SEED + 1)
    files = {k: os.path.join(tmp, f"sp_{setup}_{k}.pt")
             for k in ("weights", "batch", "reference")}
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               files["weights"])
    torch.save({k: v.cpu() for k, v in batch.items()}, files["batch"])
    state = train.create_train_state(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    t0 = time.perf_counter()
    ref_logs, ref_grads = recorded_step(
        train, loss_cfg, state, batch,
        torch.Generator(device=batch["imgs"].device).manual_seed(SEED))
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    launches.update(build.launch_counts)
    torch.save({"logs": ref_logs, "grads": ref_grads}, files["reference"])
    del model, state, batch, ref_grads
    torch.cuda.empty_cache()

    ctx = torch.multiprocessing.get_context("spawn")
    url = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(tmp, f"sp_{setup}_rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=sp_rank, args=(
        r, url, setup, files["weights"], files["batch"],
        files["reference"], outs[r])) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks_s = time.perf_counter() - t0
    if any(p.exitcode for p in procs):
        raise AssertionError(f"{tag} ranks exited with "
                             f"{[p.exitcode for p in procs]}")
    ranks = []
    for out in outs:
        with open(out) as f:
            ranks.append(json.load(f))
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    rel = max(abs(v - ref_logs[k]) / abs(ref_logs[k])
              for k, v in ranks[0]["logs"].items())
    for r in ranks:
        launches.update(r["launches"])
        for name in ("gwc_warp", "dcn_gather", "conv3d_s1"):
            if r["launches"].get(name, 0) < 1:
                raise AssertionError(f"{tag}: {name} never launched on "
                                     f"a rank ({r['launches']})")
    if (ranks[0]["logs"] != ranks[1]["logs"] or rel > 1e-4
            or ranks[0]["logs"].keys() != ref_logs.keys()
            or ranks[0]["digest"] != ranks[1]["digest"]
            or any(r["bad"] for r in ranks)):
        raise AssertionError(
            f"{tag} sharded vs one process: losses {ranks[0]['logs']} / "
            f"{ranks[1]['logs']} vs {ref_logs} (largest relative "
            f"{rel:.2e}, limit 1e-4); digests {ranks[0]['digest']} / "
            f"{ranks[1]['digest']}; leaves off "
            f"{[sorted(r['bad'], key=lambda b: -b[1])[:5] for r in ranks]}")
    return dict(ranks=ranks, ref_logs=ref_logs, rel=rel, one_ms=one_ms,
                one_peak=one_peak, ranks_s=ranks_s, launches=launches)


def phase_highres(dev, build, card: str, tmp: str) -> dict:
    """Phase 14: the high-resolution config (a 256x256x32 grid, 512x512x64
    labels). (a) one process: bf16 AdamW steps with ``bev_with_cp`` at
    B = 1 and B = 2 on seeded weights and labels, ms per step and peak
    (B = 2 only where twice B = 1's peak fits); an fp32 eval forward
    through ``infer``; K3 on the highres plan and K4 at ResNet3D level 0's
    shape against their plain versions, timed beside their library calls;
    (b) two gloo ranks on the one card sharding the grid's X over a space
    group of 2: one fp32 step against one process on the same batch.
    Returns the launches of the steps, the eval and the ranks."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import BEVDepthOccupancy
    from stereoscene_torch.ops import conv3d, voxel_pool
    from stereoscene_torch.utils.weights import seeded_init_

    t_start = time.perf_counter()
    det, label_shape, loss_cfg = highres_setup()
    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    launches = collections.Counter()

    # (a) bf16 steps at B = 1, then B = 2 where it fits
    model = BEVDepthOccupancy(det, conv3d_kernel=True,
                              label_shape=label_shape)
    seeded_init_(model, SEED)
    state = train.create_train_state(model)
    step = train.make_train_step(loss_cfg, bf16=True)
    runs = {}
    for b in (1, 2):
        if b == 2 and 2 * runs[1]["peak"] > 0.9 * total_gib:
            runs[2] = None
            break
        batch = highres_batch(det, label_shape, b, SEED + 40, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        times, losses = [], []
        for _ in range(HIGHRES_STEPS):
            t0 = time.perf_counter()
            state, logs = step(state, batch,
                               torch.Generator(device=dev).manual_seed(SEED))
            losses.append({k: float(v) for k, v in logs.items()})
            times.append((time.perf_counter() - t0) * 1e3)
        launches.update(build.launch_counts)
        runs[b] = dict(times=times, losses=losses, launches=dict(
            build.launch_counts),
            peak=torch.cuda.max_memory_allocated() / 2**30)
        # bev_with_cp's recompute launches K1 and P1 again
        per = {k: v / HIGHRES_STEPS for k, v in build.launch_counts.items()}
        if (not all(math.isfinite(v) for logs in losses
                    for v in logs.values())
                or per.get("gwc_warp") != 2 or per.get("dcn_gather") != 2
                or per.get("conv3d_s1", 0) < 12):
            raise AssertionError(f"phase 14a bf16 B = {b}: losses {losses}, "
                                 f"launches {dict(build.launch_counts)}")
        del batch
    torch.cuda.empty_cache()

    # the fp32 eval forward through infer (the serving tail), twice: the
    # first call builds and caches the highres plan on the host
    cpu_batch = highres_batch(det, label_shape, 1, SEED + 41, "cpu")
    frame = {k: v.to(dev) for k, v in cpu_batch.items()
             if not k.startswith("gt_")}
    model.eval()
    build.launch_counts.clear()
    eval_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        classes = model.infer(frame)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    eval_launches = dict(build.launch_counts)
    launches.update(eval_launches)
    if (tuple(classes.shape) != (1,) + label_shape
            or int(classes.min()) < 0 or int(classes.max()) >= 20
            or eval_launches.get("lift_splat_fused", 0) < 2):
        raise AssertionError(f"phase 14a eval: classes "
                             f"{tuple(classes.shape)}, launches "
                             f"{eval_launches}")
    del classes
    torch.cuda.empty_cache()

    # K3 on the highres plan (fp32 tables, eval's dtype)
    x = splat_inputs(model, {k: v for k, v in cpu_batch.items()
                             if not k.startswith("gt_")}, dev)
    dp, feat, order, bounds = x["dp"], x["feat"], x["order"], x["bounds"]
    group, nvox, c = x["group"], x["nvox"], feat.shape[1]

    def fused(use_kernel):
        return voxel_pool.lift_splat_fused(dp, feat, order, bounds, group,
                                           nvox, use_kernel=use_kernel)

    want = fused(False)
    err3 = check_close("phase 14 splat fused (highres)", fused(True), want,
                       1e-4 * float(want.abs().max()), 0.0)
    ms3, plain3 = cuda_ms(lambda: fused(True)), cuda_ms(lambda: fused(False))
    lib3 = cuda_ms(splat_library(dp, feat, order, bounds, group))
    live = int((order < dp.numel()).sum())
    k3 = dict(max_abs_err=err3, ms=ms3, plain_ms=plain3, library_ms=lib3,
              **bound(nbytes(dp, feat, order, bounds, want), 2 * live * c,
                      torch.float32))
    del x, dp, feat, want, model, state, frame
    torch.cuda.empty_cache()

    # K4 at ResNet3D level 0: [1, 128, 256, 256, 32] -> 128
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    xs, ys, zs = det.grid_shape
    ci = co = det.voxel_channels[0]
    xk = torch.randn(1, ci, xs, ys, zs, generator=gen, device=dev)
    wk = torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev) * ci ** -0.5
    torch.backends.cudnn.allow_tf32 = False
    errs4 = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        xd, wd = xk.to(dtype), wk.to(dtype)
        want = conv3d.conv3d_s1_plain(xd, wd)
        errs4[dtype] = check_close(
            f"phase 14 conv3d level 0 {dtype}",
            conv3d.conv3d_s1(xd, wd, use_kernel=True), want,
            tol * float(want.float().abs().max()), 0.0)
        del want
    torch.backends.cudnn.allow_tf32 = True
    xp, wb = xk.bfloat16(), wk.bfloat16()
    del xk
    xb = xp.contiguous(memory_format=torch.channels_last_3d)
    wcl = wb.contiguous(memory_format=torch.channels_last_3d)
    ms4 = cuda_ms(lambda: conv3d.conv3d_s1(xb, wb, use_kernel=True), iters=10)
    plain4 = cuda_ms(lambda: conv3d.conv3d_s1_plain(xp, wb), iters=10)
    lib4 = cuda_ms(lambda: torch.nn.functional.conv3d(xb, wcl, padding=1),
                   iters=10)
    y4 = conv3d.conv3d_s1(xb, wb, use_kernel=True)
    flop4 = 2 * y4.numel() * 27 * ci
    k4 = dict(max_abs_err=max(errs4.values()), ms=ms4, plain_ms=plain4,
              library_ms=lib4, **bound(nbytes(xb, wb, y4), flop4,
                                       torch.bfloat16))
    del xp, xb, wb, wcl, y4
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_start

    # (b) the grid sharded over two gloo ranks, fp32, B = 1, TF32 off,
    # against one process on the same batch and weights
    t_b = time.perf_counter()
    sp = sharded_step("highres", highres_batch(det, label_shape, 1,
                                               SEED + 43, dev),
                      tmp, build, "phase 14b")
    launches.update(sp["launches"])
    ranks, ref_logs, rel = sp["ranks"], sp["ref_logs"], sp["rel"]
    one_ms, one_peak, ranks_s = sp["one_ms"], sp["one_peak"], sp["ranks_s"]
    t_b = time.perf_counter() - t_b

    def fmt(run):
        return (f"ms per step {statistics.median(run['times'][1:]):.1f} "
                f"(samples {', '.join(f'{t:.1f}' for t in run['times'])}), "
                f"peak {run['peak']:.2f} GiB, loss_total "
                f"{run['losses'][0]['loss_total']:.4f} -> "
                f"{run['losses'][-1]['loss_total']:.4f}")

    b2 = (fmt(runs[2]) if runs[2] is not None else
          f"not run: twice B = 1's peak ({2 * runs[1]['peak']:.2f} GiB) "
          f"exceeds 90% of the card's {total_gib:.1f} GiB")
    print(f"phase 14a highres ({HIGHRES_CONFIG}: grid "
          f"{'x'.join(map(str, det.grid_shape))}, labels "
          f"{'x'.join(map(str, label_shape))}, D {det.num_depth}, "
          f"stream_voxel_chunks {loss_cfg.stream_voxel_chunks}, bev_with_cp, "
          f"K4 on) on {card}: bf16 AdamW steps at B = 1: {fmt(runs[1])}; "
          f"at B = 2: {b2}; launches a step at B = 1 "
          f"{ {k: v // HIGHRES_STEPS for k, v in runs[1]['launches'].items()} }"
          f"; fp32 eval forward through infer -> "
          f"[1, {', '.join(map(str, label_shape))}] ms "
          f"{eval_ms[1]:.1f} (the first, building the plan on the host: "
          f"{eval_ms[0]:.1f}); K3 on the highres plan ({len(order)} rows, "
          f"{live} live -> [{nvox}, {c}]): max abs err {err3:.3e}, kernel "
          f"{ms3:.4f} ms plain {plain3:.4f} ms embedding_bag {lib3:.4f} ms "
          f"bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}, the kernel at "
          f"{k3['bound_ms'] / ms3:.1%} of it); K4 at ResNet3D level 0 "
          f"[1, {ci}, {xs}, {ys}, {zs}] -> {co}: max abs err fp32 "
          f"{errs4[torch.float32]:.3e} bf16 {errs4[torch.bfloat16]:.3e}; "
          f"bf16 kernel {ms4:.3f} ms ({flop4 / ms4 / 1e9:.1f} TFLOP/s, "
          f"{k4['bound_ms'] / ms4:.1%} of the bound) plain {plain4:.3f} ms "
          f"cuDNN {lib4:.3f} ms ({ms4 / lib4:.2f}x cuDNN) bound "
          f"{k4['bound_ms']:.3f} ms ({k4['bound_by']}); {t_a:.1f} s",
          flush=True)
    print(f"phase 14b highres sharded over 2 gloo ranks on {card} (data 1 x "
          f"space 2, X slabs of {det.grid_shape[0] // 2}; two ranks "
          f"time-slicing one card), fp32 B = 1, TF32 off, bev_with_cp, K4 "
          f"on: loss_total {ranks[0]['logs']['loss_total']:.6f} vs one "
          f"process {ref_logs['loss_total']:.6f} (largest relative "
          f"difference of {len(ref_logs)} terms {rel:.2e}, limit 1e-4); "
          f"{ranks[0]['leaves']} gradient leaves within 2% (floor "
          f"{ranks[0]['floor']:.2e}; worst "
          f"{max(r['worst'] for r in ranks):.2e} of its leaf); parameter "
          f"digests equal on the ranks; ms per step by rank "
          f"{[round(r['step_ms'], 1) for r in ranks]} (one process "
          f"{one_ms:.1f}); halo bytes sent per step by rank "
          f"{[r['halo']['bytes'] for r in ranks]} in "
          f"{ranks[0]['halo']['exchanges']} exchanges; peak GiB by rank "
          f"{[round(r['peak'], 2) for r in ranks]} (one process "
          f"{one_peak:.2f}); launches by rank "
          f"{[r['launches'] for r in ranks]}; ranks {ranks_s:.1f} s, "
          f"{t_b:.1f} s; phase 14 "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(launches), k3, k4


DEPTHS = (34, 50, 101)  # phase 15a's ResNet3D depths
DEPTH_STEPS = 8  # phase 15a's bf16 steps a depth (the first is set-up)
DEPTH_INFERS = 5  # phase 15a's timed ``infer`` calls a depth


def phase_depths(dev, build, card: str) -> dict:
    """Phase 15a: the flagship at ResNet3D depths 34, 50 and 101 with K4
    (``conv3d_kernel=True``): at each depth the fp32 eval forward with the
    kernels (K1, K3, P1, K4) against the plain route of the same weights
    built without K4 (depth_prob 2e-4, logits 2e-3 of max|ref|, TF32
    off), its class map through ``infer`` (timed ``DEPTH_INFERS`` times),
    and K4's launches in the forward and, printed only, in the 3D encoder
    alone (none fails); at depth 50 an fp32 step with the kernels and one
    without (``kernel_step_pair``); at 18, 50 and 101 bf16 B = 1 steps
    with ``bev_with_cp``: ms per step and peak. Returns the launches of
    the forwards, ``infer`` and the steps (not of the encoder-alone
    run, which no path makes)."""
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.utils.weights import seeded_init_

    t_start = time.perf_counter()
    launches = collections.Counter()
    frame = _frames.frame(DetectorConfig(), dev, SEED + 50)
    evals = {}
    for depth in DEPTHS:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = DetectorConfig(backbone_with_cp=False, resnet_depth=depth)
        plain = BEVDepthOccupancy(cfg)
        seeded_init_(plain, SEED)
        model = BEVDepthOccupancy(cfg, conv3d_kernel=True)
        seeded_init_(model, SEED)
        build.launch_counts.clear()
        with_k = model(frame, use_kernel=True)
        counts = dict(build.launch_counts)
        without = plain(frame, use_kernel=False)
        torch.cuda.synchronize()
        del plain
        if build.launch_counts != counts:
            raise AssertionError(f"phase 15a depth {depth}: the plain "
                                 f"route launched a kernel")
        dp_err = max_err(with_k["depth_prob"], without["depth_prob"])
        ref = without["output_voxels"]
        logit_err = max_err(with_k["output_voxels"], ref) / float(
            ref.abs().max())
        build.launch_counts.clear()
        infer_ms = []
        for _ in range(DEPTH_INFERS):
            t0 = time.perf_counter()
            classes = model.infer(frame, use_kernel=True)
            torch.cuda.synchronize()
            infer_ms.append((time.perf_counter() - t0) * 1e3)
        counts_infer = dict(build.launch_counts)
        vox = torch.randn((1, cfg.numC_Trans) + cfg.grid_shape, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED + depth))
        build.launch_counts.clear()
        with torch.no_grad():
            outs = model.img_bev_encoder_backbone(vox)
        k4_encoder = build.launch_counts.get("conv3d_s1", 0)
        launches.update(counts)
        launches.update(counts_infer)
        widths = [o.shape[1] for o in outs]
        if (dp_err > 2e-4 or logit_err > 2e-3
                or not all(bool(torch.isfinite(v).all())
                           for v in with_k.values())
                or tuple(classes.shape) != (1,) + LABEL_SHAPE
                or k4_encoder < 1 or counts.get("conv3d_s1", 0) < 1
                or counts.get("gwc_warp") != 1
                or counts.get("dcn_gather") != 1
                or counts.get("lift_splat_fused") != 1):
            raise AssertionError(
                f"phase 15a depth {depth}: depth_prob {dp_err:.3e} (limit "
                f"2e-4), logits / max|ref| {logit_err:.3e} (limit 2e-3), "
                f"classes {tuple(classes.shape)}, launches {counts}, K4 in "
                f"the 3D encoder {k4_encoder}")
        evals[depth] = dict(dp=dp_err, logits=logit_err, infer_ms=infer_ms,
                            k4=counts.get("conv3d_s1", 0),
                            k4_encoder=k4_encoder, widths=widths,
                            params=sum(p.numel() for p in model.parameters()))
        del model, with_k, without, classes, outs, vox
        torch.cuda.empty_cache()

    # depth 50: an fp32 step with the kernels (K1, P1, K4) and one without
    cfg50 = DetectorConfig(resnet_depth=50)
    batch = train_batch(cfg50, SEED + 51, dev)
    build.launch_counts.clear()
    # K4: the view transformer's 8 and one Bottleneck conv2 a stage-0
    # block (3)
    pair = kernel_step_pair(cfg50, batch, dev, build, train,
                            train.LossConfig(), "phase 15a depth 50",
                            seeded_init_, BEVDepthOccupancy, min_k4=11)
    launches.update(pair["launches"])
    torch.cuda.empty_cache()

    # depths 18, 50 and 101: bf16 B = 1 steps with bev_with_cp
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    steps = {}
    for depth in (18, 50, 101):
        cfg = DetectorConfig(resnet_depth=depth, bev_with_cp=True)
        model = BEVDepthOccupancy(cfg, conv3d_kernel=True)
        seeded_init_(model, SEED)
        state = train.create_train_state(model)
        step = train.make_train_step(train.LossConfig(), bf16=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.launch_counts.clear()
        times, losses = [], []
        for _ in range(DEPTH_STEPS):
            t0 = time.perf_counter()
            state, logs = step(state, batch,
                               torch.Generator(device=dev).manual_seed(SEED))
            losses.append(float(logs["loss_total"]))
            times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(build.launch_counts)
        launches.update(counts)
        per = {k: v / DEPTH_STEPS for k, v in counts.items()}
        if (not all(math.isfinite(v) for v in losses)
                or per.get("gwc_warp") != 2 or per.get("dcn_gather") != 2
                or per.get("conv3d_s1", 0) < 12):
            raise AssertionError(f"phase 15a bf16 depth {depth}: losses "
                                 f"{losses}, launches {counts}")
        steps[depth] = dict(times=times, losses=losses, per=per,
                            peak=torch.cuda.max_memory_allocated() / 2**30)
        del model, state, step
        torch.cuda.empty_cache()
    del batch
    per_depth = "; ".join(
        f"depth {d}: stage widths {e['widths']}, {e['params'] / 1e6:.2f} M "
        f"parameters, depth_prob {e['dp']:.3e}, logits / max|ref| "
        f"{e['logits']:.3e}, infer ms {statistics.median(e['infer_ms']):.1f} "
        f"(median of {DEPTH_INFERS}; samples "
        f"{', '.join(f'{t:.1f}' for t in e['infer_ms'])}; K4 on, fp32 "
        f"kernel), K4 launches a forward {e['k4']} (3D encoder "
        f"{e['k4_encoder']})" for d, e in evals.items())
    bf16 = "; ".join(
        f"depth {d}: ms per step {statistics.median(r['times'][1:]):.1f} "
        f"(median of the last {DEPTH_STEPS - 1}, min "
        f"{min(r['times'][1:]):.1f}, max {max(r['times'][1:]):.1f}; "
        f"samples {', '.join(f'{t:.1f}' for t in r['times'])}), peak "
        f"{r['peak']:.2f} GiB, loss_total {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}, launches a step {r['per']}"
        for d, r in steps.items())
    print(f"phase 15a ResNet3D depths {DEPTHS} on the flagship with K4 on "
          f"{card}: fp32 eval forward, kernels vs plain (TF32 off): "
          f"{per_depth}; depth 50 fp32 step, kernels vs plain: loss "
          f"{pair['loss']:.6f} vs {pair['plain']:.6f}, {pair['leaves']} "
          f"grad leaves within 2% (floor {pair['floor']:.2e}), launches "
          f"{pair['launches']}; bf16 B = 1 steps with bev_with_cp: {bf16}; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(launches)


def branch_batch(tree: tuple, dev) -> dict:
    """One train frame of the tree (B = 1) through the flagship train
    pipeline with LiDAR (points, depth) and the relation labels of stage
    2's grid (16, 16, 2), as tensors on ``dev``."""
    from stereoscene_torch.engine.loop import to_device

    batches, _, _ = optional_batches(branches_setup()[0], tree, 1)
    return to_device({k: np.asarray(v)[:1] for k, v in batches[0].items()},
                     dev)


def phase_sharded_branches(dev, build, card: str, tmp: str,
                           tree: tuple) -> dict:
    """Phase 15b: the branches that read the whole grid on a sharded
    flagship grid: two gloo ranks on the one card at (data 1, space 2), X
    slabs of 32, CRP3D, the point branch and the OHEM, dice and LGA voxel
    terms on beside ce, sem_scal, geo_scal, depth, the relation loss and
    the point CE and Lovasz terms, no streaming; one fp32 step (TF32 off)
    against one process (``sharded_step``). Returns its launches."""
    t0 = time.perf_counter()
    det = branches_setup()[0]
    sp = sharded_step("branches", branch_batch(tree, dev), tmp, build,
                      "phase 15b")
    ranks, ref = sp["ranks"], sp["ref_logs"]
    names = ("loss_voxel_ohem_0", "loss_voxel_dice_0", "loss_voxel_lga_0",
             "loss_rel_ce", "loss_point_ce", "loss_point_lovasz")
    missing = [n for n in names if n not in ref]
    if missing or not all(math.isfinite(v) for v in ref.values()):
        raise AssertionError(f"phase 15b: missing {missing} or non-finite "
                             f"terms {ref}")
    print(f"phase 15b the whole-grid branches sharded over 2 gloo ranks on "
          f"{card} (data 1 x space 2, X slabs of "
          f"{det.grid_shape[0] // 2}; "
          f"two ranks time-slicing one card), fp32 B = 1, TF32 off, K4 on, "
          f"CRP3D {det.crp_mega_shape}, the point branch, OHEM, dice, LGA: "
          f"terms {ranks[0]['logs']} vs one process {ref} (largest "
          f"relative difference {sp['rel']:.2e}, limit 1e-4); "
          f"{ranks[0]['leaves']} gradient leaves within 2% (floor "
          f"{ranks[0]['floor']:.2e}; worst "
          f"{max(r['worst'] for r in ranks):.2e} of its leaf); digests "
          f"equal; ms per step by rank "
          f"{[round(r['step_ms'], 1) for r in ranks]} (one process "
          f"{sp['one_ms']:.1f}); bytes a step by rank: halo sent "
          f"{[r['halo']['bytes'] for r in ranks]} in "
          f"{ranks[0]['halo']['exchanges']} exchanges, gathered "
          f"{[r['halo']['gathered'] for r in ranks]}; peak GiB by rank "
          f"{[round(r['peak'], 2) for r in ranks]} (one process "
          f"{sp['one_peak']:.2f}); launches by rank "
          f"{[r['launches'] for r in ranks]}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(sp["launches"])


def phase_native(card: str, tree: tuple) -> None:
    """Phase 15c: one train frame's LiDAR products (its 120,000-point
    sweep, the flagship train pipeline) through the native host library
    and through the numpy route: host ms of each (median of 5), the route
    this machine takes (it must be the native one) and the pixels where
    the two routes' depth and label maps differ."""
    from stereoscene_torch import native
    from stereoscene_torch.data import (
        PipelineConfig,
        SemanticKittiIndex,
        SemanticKittiPipeline,
    )
    from stereoscene_torch.data.pipeline import lidar_route

    root, ann, lidar_root = tree
    if lidar_route() != "native":
        raise AssertionError("phase 15c: the native host library did not "
                             "build or load (g++)")
    pipe = SemanticKittiPipeline(PipelineConfig(
        input_size=(384, 1280), is_train=True, load_lidar_depth=True))
    frame = SemanticKittiIndex(data_root=root, ann_file=ann, split="train",
                               lidar_root=lidar_root,
                               lidarseg_root=lidar_root).frames[0]
    sample = pipe(frame, seed=SEED)
    products, ms = {}, {}
    available = native.available
    for route in ("native", "numpy"):
        if route == "numpy":
            native.available = lambda: False
        try:
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                products[route] = pipe._lidar_products(frame, sample)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            native.available = available
        ms[route] = times
    diff = {k: int((products["native"][k] != products["numpy"][k]).sum())
            for k in ("gt_depth", "img_seg")}
    hits = [int((products["native"]["gt_depth"][e] > 0).sum())
            for e in range(2)]
    same = all(np.array_equal(products["native"][k], products["numpy"][k])
               for k in ("points_occ", "points_uv", "points_count"))
    if min(hits) < N_LIDAR_POINTS // 2 or not same:
        raise AssertionError(f"phase 15c: gt_depth pixels per eye {hits}, "
                             f"points equal on both routes {same}")
    print(f"phase 15c LiDAR products of one {N_LIDAR_POINTS}-point sweep on "
          f"the host of {card}'s machine: route {lidar_route()}; host ms "
          f"native {statistics.median(ms['native']):.2f} (samples "
          f"{', '.join(f'{t:.2f}' for t in ms['native'])}), numpy "
          f"{statistics.median(ms['numpy']):.2f} (samples "
          f"{', '.join(f'{t:.2f}' for t in ms['numpy'])}); pixels where the "
          f"routes differ (both eyes, of {hits} hit) {diff}; points_* equal",
          flush=True)


def phase_dataset_tools(dev, card: str, tmp: str, tree: tuple,
                        eval_gflop: str) -> None:
    """Phase 15d: the dataset CLIs of the port on phase 8's tree:
    ``print_config`` on the flagship config (JSON), ``debug_dataset`` on
    two train frames with LiDAR (the route line says native), ``create_data
    semantickitti`` on one frame of packed voxel labels at full size
    (scales 1_1 and 1_2), and ``flops_table`` on the card: its three
    stages' total, which must print as phase 10's eval CLI ``--flops``
    count of the same forward (``eval_gflop``, GFLOP to 2 places)."""
    import io

    import stereoscene_torch
    from stereoscene_torch.tools import (
        create_data,
        debug_dataset,
        flops_table,
        print_config,
    )

    t0 = time.perf_counter()
    root, ann, lidar_root = tree
    flagship = os.path.join(os.path.dirname(stereoscene_torch.__file__),
                            "configs", EVAL_CONFIG)

    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        return out.getvalue(), result

    text, _ = run(print_config.main, [flagship])
    merged = json.loads(text)
    config = os.path.join(tmp, "tools_config.py")
    with open(config, "w") as f:
        f.write(f"_base_ = [{flagship!r}]\n"
                f"data = dict(train=dict(data_root={root!r}, "
                f"ann_file={ann!r}))\nlidar_root = {lidar_root!r}\n"
                f"lidarseg_root = {lidar_root!r}\n")
    debug, _ = run(debug_dataset.main, [config, "--num-frames", "2"])
    lines = debug.splitlines()
    rng = np.random.default_rng(SEED + 150)
    voxels = os.path.join(tmp, "kitti", "dataset", "sequences", "00",
                          "voxels")
    os.makedirs(voxels)
    n = int(np.prod(LABEL_SHAPE))
    rng.choice([0, 10, 40, 44, 48, 50, 70, 252], n).astype(
        np.uint16).tofile(os.path.join(voxels, "000000.label"))
    np.packbits(rng.random(n) < 0.1).tofile(
        os.path.join(voxels, "000000.invalid"))
    made, _ = run(create_data.main, [
        "semantickitti", "--root", os.path.join(tmp, "kitti"), "--out",
        os.path.join(tmp, "kitti_out"), "--scales", "1_1", "1_2"])
    labels = [np.load(os.path.join(tmp, "kitti_out", "labels", "00",
                                   f"000000_{s}.npy")) for s in ("1_1",
                                                                 "1_2")]
    table_text, table = run(flops_table.main, [flagship, "--device",
                                               str(dev)])
    stages = [table[name] for name in flops_table.STAGES]
    if (lines[0] != "LiDAR depth route: native"
            or not any(line.startswith("  gt_depth") for line in lines)
            or "img_backbone" not in merged["model"]
            or made != "wrote 2 label files\n"
            or labels[0].shape != LABEL_SHAPE
            or labels[1].shape != tuple(s // 2 for s in LABEL_SHAPE)
            or min(stages) <= 0
            or f"{table['TOTAL'] / 1e9:.2f}" != eval_gflop):
        raise AssertionError(f"phase 15d: debug_dataset {lines[:3]}, "
                             f"create_data {made!r}, shapes "
                             f"{[a.shape for a in labels]}, flops {table} "
                             f"vs the eval CLI's {eval_gflop} GFLOP")
    print(f"phase 15d dataset CLIs on {card}: print_config "
          f"{len(merged)} top-level keys; debug_dataset {lines[0]!r}, "
          f"{len(lines)} lines for 2 frames; create_data semantickitti "
          f"{made.strip()!r} ({labels[0].shape}, {labels[1].shape}); "
          f"flops_table on the card (GFLOP) "
          f"{ {k: round(v / 1e9, 2) for k, v in table.items()} }, the "
          f"total equal to phase 10's eval --flops {eval_gflop} GFLOP; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_slice_splat(dev) -> None:
    """K3 at the highres slice's own plan, as ``highres_slice --shards 4``
    runs it: ``slice_config`` of the highres config on the tool's frame
    (``_frames.slice_frame``), with bf16 tables (the slice's forward is
    serving's bf16), against its plain version at phase 3's tolerance,
    bitwise equal on a second launch."""
    from stereoscene_torch.config import Config
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.ops import voxel_pool
    from stereoscene_torch.tools import highres_slice

    full = DetectorConfig.from_config(Config.fromfile(highres_slice.HIGHRES))
    cfg = highres_slice.slice_config(full, 4)
    model = BEVDepthOccupancy(cfg, device=dev)
    cpu_batch = {k: v for k, v in _frames.slice_frame(cfg, "cpu").items()
                 if not k.startswith("gt_")}
    x = splat_inputs(model, cpu_batch, dev)
    t16 = (x["dp"].bfloat16(), x["feat"].bfloat16())
    order, bounds, group, nvox = x["order"], x["bounds"], x["group"], x["nvox"]

    def fused(use_kernel):
        return voxel_pool.lift_splat_fused(*t16, order, bounds, group, nvox,
                                           use_kernel=use_kernel)

    want = fused(False)
    got = fused(True)
    err = check_close("phase 16 splat fused bf16 (highres slice)", got,
                      want, 1e-4 * float(want.abs().max()), 0.0)
    if not torch.equal(got, fused(True)):
        raise AssertionError("phase 16 splat fused bf16: two launches "
                             "differ")
    ms, plain = cuda_ms(lambda: fused(True)), cuda_ms(lambda: fused(False))
    live = int((order < t16[0].numel()).sum())
    lim = bound(nbytes(*t16, order, bounds, want), 2 * live * want.shape[1],
                torch.float32)
    flagship_points = int((model.compute_ranks(_frames.frame(cfg, "cpu"))[0]
                           < nvox).sum())
    print(f"phase 16 K3 lift_splat_fused at the slice's plan (grid "
          f"{cfg.grid_shape}, fx = W/2): group-{group} plan of {len(order)} "
          f"rows, {live} live, {int((x['points'] < nvox).sum())} in-bounds "
          f"points ({flagship_points} at the flagship calibration) -> "
          f"[{nvox}, {t16[1].shape[1]}]; bf16 tables: max abs err "
          f"{err:.3e} (max|ref| {float(want.abs().max()):.3e}), two "
          f"launches bitwise equal; median of 20: kernel {ms:.4f} ms plain "
          f"{plain:.4f} ms bound {lim['bound_ms']:.4f} ms "
          f"({lim['bound_by']}, the kernel at {lim['bound_ms'] / ms:.1%} of "
          f"it)", flush=True)


def phase_tools(dev, card: str) -> dict:
    """Phase 16: K3 at the slice's plan (``phase_slice_splat``), then the
    port's measurement tools on the card, each run as
    ``python -m stereoscene_torch.tools.<tool>`` in a process of its own
    (so its numbers do not depend on what ran before it in this one):
    ``bench_train`` at B = 1 and at B = 2 with ``--bev-cp``,
    ``highres_slice --shards 4`` forward and ``--train``. Each JSON line
    must hold finite losses (``value``), ``step_ms`` > 0, 0 < ``mfu`` < 1
    on a card the tool knows the peak of (null elsewhere), the slice's
    grid ``SLICE_GRID`` and peaks under the card's memory; each run must
    launch its kernels (``TOOL_RUNS``). Returns the runs' launches, which
    each tool counts from its first step or request on (``# launches`` on
    its stderr)."""
    from stereoscene_torch.tools import bench_train

    t_start = time.perf_counter()
    phase_slice_splat(dev)
    torch.cuda.empty_cache()
    total_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    known = torch.cuda.get_device_name(dev) in bench_train.PEAK_BF16
    root = os.path.dirname(os.path.abspath(__file__))
    launches = collections.Counter()
    for tool, argv, needs in TOOL_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"stereoscene_torch.tools.{tool}",
             *argv], cwd=root, capture_output=True, text=True,
            timeout=TOOL_TIMEOUT_S)
        name = f"phase 16 {tool} {' '.join(argv)}"
        if proc.returncode != 0:
            raise AssertionError(f"{name}: exit {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
        records = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith("{")]
        counts = [json.loads(line[len("# launches "):])
                  for line in proc.stderr.splitlines()
                  if line.startswith("# launches ")]
        run = counts[0] if len(counts) == 1 else {}
        bad = len(records) != 1 or any(run.get(k, 0) < 1 for k in needs)
        for r in records:
            if tool == "bench_train":
                mfu = r["mfu"]
                mfu_ok = (mfu is not None and 0 < mfu < 1 if known
                          else mfu is None)
                bad |= (not mfu_ok or not math.isfinite(r["loss"])
                        or r["step_ms"] <= 0
                        or not r["peak_gib"] < total_gib)
            else:
                bad |= (not math.isfinite(r["value"]) or r["step_ms"] <= 0
                        or r["grid"] != SLICE_GRID
                        or not r["hbm_peak_gb"] < r["hbm_limit_gb"]
                        or abs(r["hbm_limit_gb"] - total_gib) > 1e-6)
        if bad:
            raise AssertionError(f"{name}: records {records}, launches "
                                 f"{dict(run)}\n{proc.stderr[-2000:]}")
        launches.update(run)
        notes = [line for line in proc.stderr.splitlines()
                 if line.startswith("# ") and "launches" not in line]
        print(f"{name} on {card} ({time.perf_counter() - t0:.1f} s; "
              f"{'; '.join(n[2:] for n in notes)}; launches {dict(run)}): "
              f"{json.dumps(records[0])}", flush=True)
    print(f"phase 16 {time.perf_counter() - t_start:.1f} s", flush=True)
    return dict(launches)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    from stereoscene_torch import _build
    from stereoscene_torch.engine import train
    from stereoscene_torch.models.detector import (
        BEVDepthOccupancy,
        DetectorConfig,
    )
    from stereoscene_torch.ops import (
        conv3d,
        deform_conv,
        gather,
        gwc,
        msdeform_attn,
        voxel_pool,
    )
    from stereoscene_torch.utils.weights import seeded_init_

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(card, flush=True)
    print(f"phase 0 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; device_count {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    _build.load_kernels()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "wgmma" in ln]
    nvcc = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds
            else "library already built from these sources")
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({nvcc}); "
          f"ptxas: {' | '.join(ptxas)}", flush=True)

    cfg = DetectorConfig(backbone_with_cp=False)
    k1 = phase_gwc(cfg, dev, gwc)

    model = BEVDepthOccupancy(cfg)
    seeded_init_(model, SEED)
    k3, k2 = phase_splat(model, _frames.frame(cfg, "cpu", SEED), dev,
                         voxel_pool)
    k4 = phase_conv3d(dev, conv3d)
    p1 = phase_dcn(model, dev, deform_conv)
    p2 = phase_take_rows(dev, gather)
    m1 = phase_msdeform(dev, msdeform_attn)

    phase_fp32_forward(model, _frames.frame(cfg, dev, SEED), _build)
    serving, _ = phase_serve(model, cfg, dev, _build, card)
    del model
    torch.cuda.empty_cache()

    training = phase_train(DetectorConfig(), dev, _build, train,
                           seeded_init_, BEVDepthOccupancy)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_semkitti_tree(os.path.join(tmp, "semkitti"),
                                   N_EVAL_FRAMES, N_TRAIN_FRAMES)
        evaluation = phase_eval(dev, _build, card, seeded_init_, tmp, tree)
        torch.cuda.empty_cache()
        phase9 = phase_train_cli(dev, _build, card, tmp, tree)
        train_cli = phase9["launches"]
        torch.cuda.empty_cache()
        data_parallel, eval_gflop = phase_data_parallel(
            dev, _build, card, tmp, tree, phase9)
        torch.cuda.empty_cache()
        optional = phase_optional(dev, _build, card, tmp, tree)
        torch.cuda.empty_cache()
        variants = phase_bevocc(dev, _build, card)
        nuscenes = phase_nuscenes(dev, _build, card)
        highres, _, _ = phase_highres(dev, _build, card, tmp)
        torch.cuda.empty_cache()
        t15 = time.perf_counter()
        depths = phase_depths(dev, _build, card)
        torch.cuda.empty_cache()
        branches = phase_sharded_branches(dev, _build, card, tmp, tree)
        torch.cuda.empty_cache()
        phase_native(card, tree)
        phase_dataset_tools(dev, card, tmp, tree, eval_gflop)
        print(f"phase 15 {time.perf_counter() - t15:.1f} s", flush=True)
    torch.cuda.empty_cache()
    tools = phase_tools(dev, card)
    for path, counts, needs in (
            ("serving", serving, ("gwc_warp", "dcn_gather",
                                  "lift_splat_fused")),
            ("training", training, ("gwc_warp", "dcn_gather", "conv3d_s1")),
            ("eval", evaluation, ("gwc_warp", "dcn_gather",
                                  "lift_splat_fused")),
            ("train CLI", train_cli, ("gwc_warp", "dcn_gather",
                                      "lift_splat_fused")),
            ("data parallel", data_parallel, ("gwc_warp", "dcn_gather",
                                              "lift_splat_fused")),
            ("optional branches", optional, ("gwc_warp", "dcn_gather")),
            ("bev_with_cp and DepthNetStereo", variants,
             ("gwc_warp", "dcn_gather")),
            ("nuScenes", nuscenes, ("msdeform_attn_3d",)),
            ("highres", highres, ("gwc_warp", "dcn_gather", "conv3d_s1",
                                  "lift_splat_fused")),
            ("ResNet3D depths", depths, ("gwc_warp", "dcn_gather",
                                         "conv3d_s1", "lift_splat_fused")),
            ("sharded branches", branches, ("gwc_warp", "dcn_gather",
                                            "conv3d_s1")),
            ("measurement tools", tools, ("gwc_warp", "dcn_gather",
                                          "lift_splat_fused"))):
        for name in needs:
            if counts.get(name, 0) < 1:
                raise AssertionError(f"{name} never launched in {path}")
    kernels = [
        dict(name="gwc_warp", source="stereoscene_torch/csrc/gwc_warp.cu",
             replaces="stereoscene_tpu/ops/pallas_gwc.py:144", **k1),
        dict(name="splat_sorted", source="stereoscene_torch/csrc/splat.cu",
             replaces="stereoscene_tpu/ops/pallas_splat.py:95", **k2),
        dict(name="lift_splat_fused",
             source="stereoscene_torch/csrc/splat.cu",
             replaces="stereoscene_tpu/ops/pallas_splat_fused.py:104", **k3),
        dict(name="conv3d_s1", source="stereoscene_torch/csrc/conv3d.cu",
             replaces="stereoscene_tpu/ops/pallas_conv3d.py:102", **k4),
        dict(name="dcn_gather", source="stereoscene_torch/csrc/dcn.cu",
             replaces="tools/probe_pallas_dcn.py:125", **p1),
        dict(name="take_rows", source="stereoscene_torch/csrc/gather.cu",
             replaces="tools/probe_gather.py:27", **p2),
        dict(name="msdeform_attn_3d",
             source="stereoscene_torch/csrc/msdeform.cu",
             replaces="none (the JAX package's XLA gathers)", **m1),
    ]
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = sum(run.get(k["name"], 0)
                            for run in (serving, training, evaluation,
                                        train_cli, data_parallel, optional,
                                        variants, nuscenes, highres, depths,
                                        branches, tools))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
