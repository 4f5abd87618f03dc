"""The training and evaluation loops, port of
``stereoscene_tpu/engine/loop.py``.

``run_training`` replaces ``custom_train_detector`` + ``EpochBasedRunner`` +
``OccDistEvalHook`` (ref: occupancy/apis/mmdet_train.py:28-198,
core/evaluation/eval_hooks.py:92-167): one train step per iteration on the
model's device, eval every ``eval_interval`` epochs, the best checkpoint by
``semkitti_combined_IoU`` plus the last ones (``CheckpointManager``), and
JSONL + TensorBoard logging (the reference's TextLoggerHook +
TensorboardLoggerHook at interval 50, ref projects/configs/_base_/
default_runtime.py:6-11). ``run_evaluation`` (ref: occupancy/apis/test.py:
66-139) streams the SSC metric state over a loader.

Data parallel (``parallel``), each rank with its shard of the index:

- the ranks agree on the steps per epoch, the fewest any rank's loader
  has, so shards of unequal length never leave a rank waiting in a
  collective; and on the SIGTERM flag, every step, so all save the same
  step and return together;
- rank 0 alone writes ``train_log.jsonl``, ``tf_logs`` and the
  checkpoints (the JAX loop appends the jsonl in every process); every
  rank prints its log lines;
- after init or restore, rank 0's parameters and buffers are broadcast
  once; every rank restores the same step;
- ``run_evaluation`` scores the rank's shard, then sums the int64 metric
  state over the ranks once (no collective per frame: the shards may
  differ in length), so every rank returns the same metrics. On a sharded
  grid the space ranks of one sample share its frames, and only the first
  of them scores and counts them.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import metrics as ssc_metrics
from .. import parallel
from ..utils.spans import span
from ..utils.tb_writer import TensorBoardWriter
from .checkpoint import CheckpointManager
from .train import TrainState


_END = object()  # the end of a loader's epoch


class TransferWeightHook:
    """Keep a separate eval copy of the weights, synced from the train state
    every ``every_n_iters`` steps: the reference's ``TransferWeight`` hook,
    which copies ``runner.model`` into ``runner.eval_model`` after each train
    iter (ref: bevformer/hooks/custom_hooks.py:6-13). ``eval_state_dict``
    holds copies of the model's parameters and buffers (the JAX hook's
    ``eval_params`` and ``eval_batch_stats``)."""

    def __init__(self, every_n_iters: int = 1):
        self.every_n_iters = max(1, int(every_n_iters))
        self.eval_state_dict = None

    def __call__(self, state, epoch: int, it: int, logs) -> None:
        if it % self.every_n_iters == 0:
            self.eval_state_dict = {
                k: v.detach().clone()
                for k, v in state.model.state_dict().items()}


class JsonlLogger:
    """One JSON line per record, appended to ``path`` (when given) and
    printed; values with ``.item`` (tensors, numpy scalars) as floats."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, record: Dict):
        record = {
            k: (float(v) if hasattr(v, "item") else v)
            for k, v in record.items()
        }
        line = json.dumps(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        print(line, flush=True)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The DropPath and dropout generator of train step ``step``, on
    ``device``: a function of (seed, step) alone, so a resumed run draws
    what an uninterrupted one draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2**32 + step) % 2**63)
    return gen


def run_training(
    model,
    state: TrainState,
    train_step: Callable,
    train_loader,
    eval_fn: Optional[Callable] = None,
    *,
    max_epochs: int = 30,
    eval_interval: int = 2,
    work_dir: str = "work_dir",
    log_interval: int = 50,
    seed: int = 0,
    profile: bool = False,
    trace_dir: Optional[str] = None,
    trace_steps: Tuple[int, int] = (10, 15),
    hooks: Optional[list] = None,
    save_interval_steps: int = 0,
) -> TrainState:
    """Train ``state`` (its model on its device) for ``max_epochs`` epochs of
    ``train_loader``; ``train_step(state, batch, generator) -> (state,
    logs)`` takes the batch as tensors on the model's device and the step's
    ``step_generator``. Returns the state.

    ``hooks``: callables ``(state, epoch, it, logs)`` run after every train
    step (the runner's custom hooks, ref occupancy/apis/mmdet_train.py:
    180-192; ``TransferWeightHook`` is the packaged one). ``profile`` adds
    ``step_time_s``, the step's wall time between two device
    synchronisations, to the logs; ``trace_dir`` gets a ``torch.profiler``
    chrome trace (``trace.json``) of the steps from ``trace_steps[0]`` up to
    ``trace_steps[1]``, with the program's ``utils.spans`` ranges: each
    step's ``stereoscene.load``, its phases and their stages.

    Preemption: ``save_interval_steps > 0`` adds background saves every N
    steps, SIGTERM makes a synchronous save and returns, and a run that
    finds a checkpoint in ``work_dir/ckpts`` restores it and skips the
    batches its epoch already consumed. ``train_loader.epoch``, where the
    loader has one, is set to the epoch the run starts in, so the resumed
    epoch's shuffle is the one an uninterrupted run sees."""
    del model  # the state holds it
    primary = parallel.is_primary()
    logger = JsonlLogger(
        os.path.join(work_dir, "train_log.jsonl") if primary else None)
    tb = TensorBoardWriter(os.path.join(work_dir, "tf_logs")) \
        if primary else None
    ckpt = CheckpointManager(os.path.join(work_dir, "ckpts"))
    state, start_step = ckpt.restore(state)
    parallel.broadcast_module(state.model)
    if parallel.reduce_ints([start_step], "min") != \
            parallel.reduce_ints([start_step], "max"):
        raise RuntimeError(f"rank {parallel.rank()} restored step "
                           f"{start_step}, another rank another step")
    device = next(state.model.parameters()).device

    steps_per_epoch, = parallel.reduce_ints([len(train_loader)], "min")
    start_epoch = int(start_step) // max(steps_per_epoch, 1)
    skip_iters = int(start_step) % max(steps_per_epoch, 1)
    if hasattr(train_loader, "epoch"):
        train_loader.epoch = start_epoch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # non-main thread
        prev_handler = None

    tracer = None
    try:
        global_it = 0
        for epoch in range(start_epoch, max_epochs):
            t_epoch = time.time()
            batches = iter(train_loader)
            for it in itertools.count():
                if (trace_dir is not None and tracer is None
                        and global_it == trace_steps[0]):
                    os.makedirs(trace_dir, exist_ok=True)
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(torch.profiler.ProfilerActivity.CUDA)
                    tracer = torch.profiler.profile(activities=activities)
                    tracer.start()
                if tracer is not None and global_it == trace_steps[1]:
                    tracer.stop()
                    tracer.export_chrome_trace(
                        os.path.join(trace_dir, "trace.json"))
                    tracer = None
                with span("stereoscene.load"):
                    batch = next(batches, _END)
                    if batch is _END or it == steps_per_epoch:
                        break  # the loader's end or the ranks' shortest
                    if epoch == start_epoch and it < skip_iters:
                        continue  # mid-epoch resume: realign the data cursor
                    batch = to_device(batch, device)
                global_it += 1

                generator = step_generator(seed, state.step, device)
                if profile:
                    sync()
                    t0 = time.perf_counter()
                state, logs = train_step(state, batch, generator)
                if profile:
                    sync()
                    logs["step_time_s"] = time.perf_counter() - t0
                for hook in hooks or ():
                    hook(state, epoch, it, logs)
                if (save_interval_steps
                        and state.step % save_interval_steps == 0):
                    ckpt.save(state.step, state, wait=False, epoch=epoch)
                if parallel.reduce_ints([preempted["flag"]], "max")[0]:
                    ckpt.save(state.step, state, epoch=epoch)
                    logger.log({"epoch": epoch, "iter": it,
                                "preempted_at_step": state.step})
                    return state
                if it % log_interval == 0:
                    host_logs = {k: (v.item() if torch.is_tensor(v) else v)
                                 for k, v in logs.items()}
                    logger.log({"epoch": epoch, "iter": it, **host_logs})
                    if tb is not None:
                        tb.add_scalars(
                            {f"train/{k}": float(v)
                             for k, v in host_logs.items()
                             if np.isscalar(v) or np.ndim(v) == 0},
                            step=state.step)

            metrics_out: Dict[str, float] = {}
            if eval_fn is not None and (epoch + 1) % eval_interval == 0:
                metrics_out = eval_fn(state)
                logger.log({"epoch": epoch, "eval": metrics_out})
                if tb is not None:
                    tb.add_scalars(
                        {f"val/{k}": float(v) for k, v in metrics_out.items()
                         if isinstance(v, (int, float, np.floating))},
                        step=state.step)

            ckpt.save(state.step, state, metrics=metrics_out, epoch=epoch + 1)
            logger.log({"epoch": epoch, "epoch_time_s": time.time() - t_epoch})
        return state
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if tracer is not None:
            tracer.stop()
            tracer.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        ckpt.wait()
        if tb is not None:
            tb.close()


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
    mIoU every 20 batches.

    In a process group each rank passes the loader of its own shard; the
    metric state and ``eval_frames`` are summed over the ranks at the end
    (``metrics.all_processes_state``), so every rank returns the metrics of
    all frames (``eval_time_s`` stays the rank's own)."""
    device = next(model.parameters()).device
    state = ssc_metrics.empty_state(device=device)
    t0 = time.time()
    n = 0
    batch_size = getattr(eval_loader, "batch_size", None)
    scores_frames = parallel.space_rank() == 0
    for i, batch in enumerate(eval_loader):
        n += scores_frames * int(np.asarray(
            next(iter(batch.values()))).shape[0])
        if batch_size is not None:
            batch = pad_batch(batch, batch_size)
        _, state = eval_step(model, to_device(batch, device), state,
                             use_kernel=use_kernel)
        if progress and i % 20 == 0:
            scores = ssc_metrics.compute(state)
            print(f"[eval] {n} frames, running SC IoU "
                  f"{float(scores['iou']):.4f}, mIoU "
                  f"{float(scores['iou_ssc_mean']):.4f}", flush=True)
    state = ssc_metrics.all_processes_state(state)
    out = ssc_metrics.evaluate_dict(state, class_names)
    out["eval_time_s"] = time.time() - t0
    out["eval_frames"], = parallel.reduce_ints([n])
    return out
