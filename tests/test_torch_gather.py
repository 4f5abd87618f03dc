"""The port's row gather (P2's plain route) against ``jnp.take_along_axis``
/ ``jnp.take``, the functions of the Pallas probe's three kernels
(tools/probe_gather.py: ``k_taa_full``, ``k_taa_1col``, ``k_take``), at the
probe's table width with fewer rows. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_torch.ops.gather import take_along_rows

R, C, M = 300, 128, 64


def _inputs(layout):
    rng = np.random.RandomState(len(layout))
    feat = rng.randn(R, C).astype(np.float32)
    idx = rng.randint(0, R, layout).astype(np.int32)
    return feat, idx


@pytest.mark.parametrize("layout", [(M, C), (M, 1), (M,)],
                         ids=["per_element", "per_row", "flat"])
def test_take_along_rows_matches_jax(layout):
    feat, idx = _inputs(layout)
    if len(layout) == 1:
        want = jnp.take(jnp.asarray(feat), jnp.asarray(idx), axis=0)
    else:
        want = jnp.take_along_axis(
            jnp.asarray(feat),
            jnp.broadcast_to(jnp.asarray(idx), (M, C)), axis=0)
    got = take_along_rows(torch.from_numpy(feat), torch.from_numpy(idx))
    assert got.shape == (M, C) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_take_along_rows_refuses_bad_layouts_and_the_kernel_on_cpu():
    feat, idx = _inputs((M, C))
    ft = torch.from_numpy(feat)
    with pytest.raises(ValueError, match=r"\[M\]"):
        take_along_rows(ft, torch.zeros(M, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        take_along_rows(ft, torch.from_numpy(idx), use_kernel=True)


def test_take_along_rows_plain_route_raises_on_a_bad_index():
    """The CPU route refuses an index outside [0, R); the CUDA route clamps
    it instead (tests/test_torch_kernels_cuda.py)."""
    feat, _ = _inputs((M, 1))
    for bad in (R, -R - 1):
        with pytest.raises((IndexError, RuntimeError)):
            take_along_rows(torch.from_numpy(feat),
                            torch.full((M,), bad, dtype=torch.int32))
