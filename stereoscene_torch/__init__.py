"""PyTorch / CUDA port of StereoScene inference and training for NVIDIA
Hopper.

The JAX package ``stereoscene_tpu`` stays the reference; this package keeps
its layout (``geometry``, ``ops/``, ``models/``, ``losses/``, ``engine/``,
``utils/``) and names. It imports ``torch`` and never ``jax``. The
hand-written kernels live in ``csrc/`` and are built at first use by
``_build.load_kernels``.
"""
