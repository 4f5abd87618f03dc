"""Row gather along axis 0, kernel P2.

Port of the Pallas probe ``tools/probe_gather.py`` (``run`` with
``k_taa_full``, ``k_taa_1col`` and ``k_take``): one function for the
probe's three index layouts. The kernel is ``csrc/gather.cu``
(``stereoscene_take_rows``); like K2, it lies on no model path, in the JAX
package as here.
"""

from __future__ import annotations

import torch

from .. import _build
from ._dispatch import want_kernel


def _per_element(feat: torch.Tensor, idx: torch.Tensor) -> bool:
    """True for idx [M, C] (one index per element), False for [M] / [M, 1]
    (one per row); raises on any other shape."""
    if idx.dim() == 1:
        return False
    if idx.dim() != 2 or idx.shape[1] not in (1, feat.shape[1]):
        raise ValueError(f"take_along_rows: idx {tuple(idx.shape)} is not "
                         f"[M], [M, 1] or [M, {feat.shape[1]}]")
    return idx.shape[1] != 1


def take_along_rows_plain(feat: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """The plain version of P2: ``feat.gather(0, idx.expand(M, C))``."""
    _per_element(feat, idx)
    idx = idx.reshape(idx.shape[0], -1)
    return feat.gather(0, idx.long().expand(idx.shape[0], feat.shape[1]))


def take_along_rows_kernel(feat: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """Launch ``csrc/gather.cu`` on CUDA tensors or raise: feat [R, C] fp32,
    idx int32 [M], [M, 1] or [M, C] -> [M, C]. Indices outside [0, R) are
    clamped into it by the kernel."""
    if feat.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"take_rows kernel takes fp32 feat and int32 idx, "
                        f"got {feat.dtype} and {idx.dtype}")
    if feat.dim() != 2:
        raise ValueError(f"take_rows kernel: feat {tuple(feat.shape)} is "
                         "not [R, C]")
    per_element = _per_element(feat, idx)
    (r, c), m = feat.shape, idx.shape[0]
    device = feat.get_device()
    if device < 0 or idx.get_device() != device:
        raise ValueError("take_rows kernel: feat and idx must be on one card")
    out = feat.new_empty((m, c))
    if m == 0 or c == 0:
        return out
    if r == 0:
        raise IndexError("take_rows kernel: gather from an empty table")
    feat, idx = feat.contiguous(), idx.contiguous()
    _build.launch("take_rows", device, feat.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), m, c, r, int(per_element))
    return out


def take_along_rows(feat: torch.Tensor, idx: torch.Tensor,
                    use_kernel=None) -> torch.Tensor:
    """``out[i, c] = feat[idx[i, c or 0], c]`` for feat [R, C] and idx
    shaped [M, C] (``take_along_axis``), [M, 1] (one row per output row,
    broadcast) or [M] (``take``) -> [M, C].

    On a CUDA tensor (``use_kernel`` None or True) this launches P2 or
    raises; on a CPU tensor it runs ``take_along_rows_plain``. Indices must
    lie in [0, R): the plain route raises on one outside it, the kernel
    clamps it to the nearest row (a check would cost a device sync per
    call)."""
    if want_kernel("take_along_rows", use_kernel, feat, idx):
        return take_along_rows_kernel(feat, idx)
    return take_along_rows_plain(feat, idx)
