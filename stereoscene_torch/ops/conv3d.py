"""3x3x3 stride-1 pad-1 conv3d, kernel K4.

Port of ``stereoscene_tpu/ops/pallas_conv3d.py`` (``conv3d_s1_pallas``):
the forward is the hand-written implicit GEMM ``csrc/conv3d.cu`` on a CUDA
tensor (bf16 on the tensor cores, fp32 exact on the CUDA cores),
``conv3d_s1_plain`` on a CPU tensor; the backward is the JAX package's
``_bwd``: dx and dw of the plain conv in fp32, cast back.

Tensors are torch's NCDHW. The kernel reads and writes channels-last memory
(``torch.channels_last_3d``), so a volume that already lies so costs no
copy, and its output lies so too. No bias: the caller adds it, as the JAX
package's ``_PallasConv3d`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from ._dispatch import want_kernel

# the channel counts the kernel takes (the JAX gate, models/layers.py:651)
KERNEL_CIN = (64, 128)
# the bf16 kernel's output voxels per block (csrc/conv3d.cu kTcBM)
BLOCK_M = 128


def tile_n(co: int) -> int:
    """The bf16 kernel's N tile: 128 unless Co fits in 64 (the tile table in
    csrc/conv3d.cu's header)."""
    return 128 if co > 64 else 64


def pack_weight_kmajor(weight: torch.Tensor) -> torch.Tensor:
    """[Co, Ci, 3, 3, 3] -> [27, Co, Ci], taps in (kd, kh, kw) order: the
    bf16 kernel's B operand, K (the channels) contiguous per output
    channel. The kernel packs its own copy on the card; this is the plain
    statement of that layout."""
    co, ci = weight.shape[:2]
    return weight.permute(2, 3, 4, 0, 1).reshape(27, co, ci).contiguous()


def conv3d_s1_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain version of K4: ``F.conv3d(x, w, padding=1)`` in x.dtype."""
    return F.conv3d(x, weight.to(x.dtype), padding=1)


def conv3d_s1_kernel(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/conv3d.cu`` on x [B, Ci, D, H, W] and weight
    [Co, Ci, 3, 3, 3] (CUDA, fp32 or bf16) or raise. The output is
    [B, Co, D, H, W] in x.dtype, channels-last in memory."""
    if x.dim() != 5 or weight.shape[1:] != (x.shape[1], 3, 3, 3):
        raise ValueError(f"conv3d kernel: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} are not a 3x3x3 conv3d")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3d kernel takes fp32/bf16, got {x.dtype}")
    b, ci, d, h, w = x.shape
    co = weight.shape[0]
    if ci not in KERNEL_CIN:
        raise ValueError(f"conv3d kernel takes Ci in {KERNEL_CIN}, got {ci}")
    if not x.is_cuda or weight.device != x.device:
        raise ValueError("conv3d kernel: x and weight must be on one card")
    xc = x.contiguous(memory_format=torch.channels_last_3d)
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # the kernel packs the weights K-major into wk, once per call
        wp = weight.contiguous()
        if wp.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"conv3d kernel: weight {wp.dtype}")
        wk = torch.empty((27, co, ci), dtype=torch.bfloat16, device=x.device)
        block_n = tile_n(co)
        if xc.data_ptr() % 16:
            raise ValueError("conv3d kernel: bf16 x must be 16-byte aligned")
    else:  # [Co, Ci, kd, kh, kw] -> [(kd kh kw), Ci, Co], pallas_conv3d.py:97
        wp = weight.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(27, ci, co)
        wp = wp.contiguous()
        wk, block_n = wp, 0
    out = torch.empty((b, co, d, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last_3d)
    _build.launch(
        "conv3d_s1", x.get_device(), xc.data_ptr(), wp.data_ptr(),
        wk.data_ptr(), out.data_ptr(), b, d, h, w, ci, co, int(bf16),
        int(wp.dtype == torch.float32), block_n)
    return out


class Conv3dS1(torch.autograd.Function):
    """``forward(x, weight, impl)`` runs ``impl(x, weight)`` (the kernel or
    the plain version); the backward is the plain conv's, in fp32
    (pallas_conv3d.py:156-169), whichever forward ran."""

    @staticmethod
    def forward(ctx, x, weight, impl):
        ctx.save_for_backward(x, weight)
        return impl(x, weight)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g = grad.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(
                x.shape, weight.float(), g, padding=1).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(
                x.float(), weight.shape, g, padding=1).to(weight.dtype)
        return dx, dw, None


def conv3d_s1(x: torch.Tensor, weight: torch.Tensor,
              use_kernel=None) -> torch.Tensor:
    """Exact 3x3x3 stride-1 pad-1 conv3d without bias, differentiable.

    On a CUDA tensor (``use_kernel`` None or True) the forward launches K4
    or raises; on a CPU tensor it is ``conv3d_s1_plain``."""
    kernel = want_kernel("conv3d_s1", use_kernel, x, weight,
                         differentiable=True)
    impl = conv3d_s1_kernel if kernel else conv3d_s1_plain
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return Conv3dS1.apply(x, weight, impl)
    return impl(x, weight)  # nothing to differentiate: no autograd node
