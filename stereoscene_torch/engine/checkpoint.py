"""Checkpoints of a train state, port of
``stereoscene_tpu/engine/checkpoint.py``: keep the last ``max_to_keep``
and the best by ``semkitti_combined_IoU`` (ref: config stereoscene.py:
217-225; eval_hooks.py:163-166).

One file per step, ``<directory>/<step>.pth``, in the mmcv layout::

    {"meta": {"step", "updates", "epoch", "metrics"},
     "state_dict": model.state_dict(),      # the reference's key layout
     "optimizer": optimizer.state_dict(),
     "grad_sum": [...]}                     # only while gradients accumulate

so ``tools/test.py: load_checkpoint`` reads the file as it is. A save is
written under a temporary name (``.<step>.pth.tmp``, which a save cut
before its rename leaves behind and a reader ignores) and renamed into
place.

Which steps survive follows the JAX package's orbax manager
(``best_mode="max"``, ``keep_checkpoints_without_metrics=True``; its
``save`` passes ``metrics or {}``): every step is scored
``metrics.get(best_metric_key, -1.0)``, the ``max_to_keep`` best survive,
a tie goes to the later step, and a save of a step at or below the latest
surviving step is skipped. So a save without metrics is dropped at once
when ``max_to_keep`` evaluated steps survive.

In a process group (``parallel``) every rank calls ``save`` with the same
steps and metrics and keeps the same books, so all agree on which steps
survive and which is the latest; rank 0 alone writes and deletes files,
the background writes included. A save that waits ends in a barrier, so
its file is there for every rank when ``save`` returns.
"""

from __future__ import annotations

import numbers
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

import torch

from .. import parallel

_STEP_FILE = re.compile(r"^(\d+)\.pth$")


def _to_cpu(obj):
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        out = type(obj)((k, _to_cpu(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):  # a state_dict's module versions
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    """Saves and restores ``engine.train.TrainState``: the model's
    parameters and buffers, the optimizer state, ``step``, ``updates`` and
    ``grad_sum``."""

    def __init__(self, directory: str, max_to_keep: int = 2,
                 best_metric_key: str = "semkitti_combined_IoU"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric_key = best_metric_key
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # (step, metrics) of the surviving steps, in step order
        self._saved: List[Tuple[int, Dict]] = []
        steps = sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)
        for step in steps:
            meta = torch.load(self.path(step), map_location="cpu",
                              weights_only=True, mmap=True)["meta"]
            self._saved.append((step, meta.get("metrics") or {}))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pth")

    def _score(self, metrics: Dict) -> float:
        return metrics.get(self.best_metric_key, -1.0)

    def _ranked(self) -> List[Tuple[int, Dict]]:
        """Surviving steps from worst to best (stable: a tie ranks the
        later step higher)."""
        return sorted(self._saved, key=lambda s: self._score(s[1]))

    def save(self, step: int, state, metrics: Optional[Dict] = None,
             wait: bool = True, epoch: Optional[int] = None) -> bool:
        """Save ``state`` as ``step``; False when the step is skipped (at or
        below the latest surviving step) or scores outside the best
        ``max_to_keep``. The state is copied to the CPU here; with
        ``wait=False`` a background thread writes it (the next save or
        ``wait()`` joins it). ``epoch``: the epochs completed, for the
        meta."""
        latest = self.latest_step
        saved = latest is None or step > latest
        if saved:
            metrics = {k: float(v) if isinstance(v, numbers.Real) else v
                       for k, v in (metrics or {}).items()}
            self._saved.append((step, metrics))
            keep = {s for s, _ in self._ranked()[-self.max_to_keep:]}
            gone = [s for s, _ in self._saved if s not in keep]
            self._saved = [s for s in self._saved if s[0] in keep]
            saved = step in keep
            payload = None
            if saved and parallel.is_primary():
                payload = {
                    "meta": {"step": int(state.step),
                             "updates": int(state.updates), "epoch": epoch,
                             "metrics": metrics},
                    "state_dict": _to_cpu(state.model.state_dict()),
                    "optimizer": _to_cpu(state.optimizer.state_dict()),
                }
                if state.grad_sum is not None:
                    payload["grad_sum"] = _to_cpu(state.grad_sum)
            self.wait()
            if parallel.is_primary():
                self._thread = threading.Thread(
                    target=self._write, args=(step, payload, gone),
                    daemon=True)
                self._thread.start()
        if wait:
            self.wait()
            parallel.barrier()
        return saved

    def _write(self, step: int, payload: Optional[Dict],
               gone: List[int]) -> None:
        try:
            if payload is not None:
                tmp = os.path.join(self.directory, f".{step}.pth.tmp")
                torch.save(payload, tmp)
                os.replace(tmp, self.path(step))
            for old in gone:
                if os.path.exists(self.path(old)):
                    os.remove(self.path(old))
        except Exception as e:  # raised again by wait()
            self._error = e

    def wait(self) -> None:
        """Join the background write, raising its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (by default the latest) into ``state`` in place ->
        (state, step); (state, 0) when there is no checkpoint."""
        self.wait()
        step = self.latest_step if step is None else step
        if step is None:
            return state, 0
        ckpt = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        state.model.load_state_dict(ckpt["state_dict"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["meta"]["step"])
        state.updates = int(ckpt["meta"]["updates"])
        device = next(state.model.parameters()).device
        grad_sum = ckpt.get("grad_sum")
        state.grad_sum = (None if grad_sum is None
                          else [g.to(device) for g in grad_sum])
        return state, step

    @property
    def latest_step(self) -> Optional[int]:
        return self._saved[-1][0] if self._saved else None

    @property
    def best_step(self) -> Optional[int]:
        return self._ranked()[-1][0] if self._saved else None
