"""Named ranges at the program's stage and step boundaries.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler is active, so every span lands in the profiler's trace on the
same clock as the device operations it launched. With no profiler active
it is one shared null context, after a single check of torch's own flag:
no operator is dispatched and nothing is allocated. The profiler is the
only switch.

``SPANS`` lists every name, each under its parent:

- serving, once a frame: ``stereoscene.infer`` holds ``.plan`` (with
  ``.plan.build`` on a plan-cache miss only), ``.images`` (with
  ``.images.replay`` where the image backbone replays its CUDA graph, and
  ``.images.capture`` the one time it captures it), ``.view`` (with
  ``.view.stereo``, ``.view.depth``, ``.view.mie``, ``.view.splat``),
  ``.bev`` (with, under a Mask2Former head, ``.head.encoder``, the pixel
  decoder, and ``.head.decoder``, the query decoder's predictions and
  layers) and ``.classmap``; ``stereoscene.msdeform`` opens at each call
  of the 3D deformable attention (``ops.msdeform_attn.msdeform_attn_3d``),
  wherever it is called from, and holds ``stereoscene.msdeform.kernel``
  around the launch where the call takes the CUDA kernel
  (``csrc/msdeform.cu``); the stage spans open in training too, and a
  checkpointed block's recompute opens them again inside the backward;
- training, once a step: ``stereoscene.forward`` (the model and the
  losses), ``stereoscene.backward`` (``torch.autograd.grad``),
  ``stereoscene.optimizer`` (the gradients' reduction, the clip and the
  update), and in ``engine.loop.run_training`` ``stereoscene.load`` (the
  wait for the loader's batch and its copy to the device).
"""

from __future__ import annotations

import contextlib

from torch.autograd.profiler import record_function
from torch._C._autograd import _profiler_enabled

SPANS = (
    "stereoscene.infer",
    "stereoscene.plan",
    "stereoscene.plan.build",
    "stereoscene.images",
    "stereoscene.images.capture",
    "stereoscene.images.replay",
    "stereoscene.view",
    "stereoscene.view.stereo",
    "stereoscene.view.depth",
    "stereoscene.view.mie",
    "stereoscene.view.splat",
    "stereoscene.bev",
    "stereoscene.head.encoder",
    "stereoscene.head.decoder",
    "stereoscene.msdeform",
    "stereoscene.msdeform.kernel",
    "stereoscene.classmap",
    "stereoscene.forward",
    "stereoscene.backward",
    "stereoscene.optimizer",
    "stereoscene.load",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler is active, else a
    shared null context."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF
