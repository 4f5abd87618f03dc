"""PyTorch / CUDA port of StereoScene inference, training and evaluation
for NVIDIA Hopper.

The JAX package ``stereoscene_tpu`` stays the reference; this package keeps
its layout (``config``, ``configs/``, ``data/``, ``geometry``, ``metrics``,
``ops/``, ``models/``, ``losses/``, ``engine/``, ``utils/``; the train and
eval CLIs in ``tools/``) and names. It imports ``torch`` and never ``jax``.
The hand-written kernels live in ``csrc/`` and are built at first use by
``_build.load_kernels``.
"""
