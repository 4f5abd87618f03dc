"""Group-wise correlation volume + disparity->depth warp.

Port of ``stereoscene_tpu/ops/gwc.py`` (the plain pair) and
``stereoscene_tpu/ops/pallas_gwc.py`` (the fused kernel K1, here
``csrc/gwc_warp.cu``). All public functions keep the JAX layouts:
features [B, H, W, C], volumes [B, D|K, H, W, G].
"""

from __future__ import annotations

import torch

from .. import _build
from ._dispatch import want_kernel


def groupwise_correlation_volume(
    left: torch.Tensor, right: torch.Tensor, max_disp: int, num_groups: int
) -> torch.Tensor:
    """vol[b, i, h, w, g] = mean_c left[b, h, w, g*cpg + c] *
    right[b, h, w - i, g*cpg + c], zero where w - i < 0
    (ref: ViewTransformerLSSVoxel.py:97-114). fp32 products and mean,
    returned in fp32."""
    b, h, w, c = left.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    cpg = c // num_groups
    lf, rf = left.float(), right.float()
    vol = lf.new_zeros(b, max_disp, h, w, num_groups)
    for i in range(min(max_disp, w)):
        prod = lf[:, :, i:] * rf[:, :, :w - i]
        vol[:, i, :, i:] = prod.view(b, h, w - i, num_groups, cpg).mean(-1)
    return vol


def warp_coeffs(positions: torch.Tensor, num_disp: int):
    """grid_sample(align_corners=True, zero padding) lerp coefficients of
    the depth warp: i0 [B, K] int32 clipped to [-1, D-1], and w0 / w1
    [B, K] fp32 with out-of-range corners zeroed."""
    pos = positions.float()
    i0 = torch.floor(pos).to(torch.int32)
    i1 = i0 + 1
    w1 = pos - i0.float()
    w0 = 1.0 - w1
    w0 = w0 * ((i0 >= 0) & (i0 <= num_disp - 1)).float()
    w1 = w1 * ((i1 >= 0) & (i1 <= num_disp - 1)).float()
    return i0.clamp(-1, num_disp - 1), w0, w1


def warp_disparity_to_depth(
    volume: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Resample the disparity axis of [B, D, H, W, G] at the fractional
    positions [B, K] (linear, zero outside [0, D-1]) -> [B, K, H, W, G]
    (ref: ViewTransformerLSSVoxel.py:128-156)."""
    num_disp = volume.shape[1]
    i0, w0, w1 = warp_coeffs(positions, num_disp)
    i0 = i0.long()
    bidx = torch.arange(volume.shape[0], device=volume.device)[:, None]
    g0 = volume[bidx, i0.clamp(0, num_disp - 1)]
    g1 = volume[bidx, (i0 + 1).clamp(0, num_disp - 1)]
    return (g0 * w0[:, :, None, None, None]
            + g1 * w1[:, :, None, None, None])


def gwc_warp_plain(left, right, positions, max_disp, num_groups,
                   out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of K1: correlation volume, then warp, in
    fp32; cast once at the end."""
    vol = groupwise_correlation_volume(left, right, max_disp, num_groups)
    out = warp_disparity_to_depth(vol, positions)
    return out.to(out_dtype or left.dtype)


def gwc_warp_kernel(left, right, positions, max_disp, num_groups,
                    out_dtype) -> torch.Tensor:
    """Launch ``csrc/gwc_warp.cu`` (K1) on CUDA tensors or raise. The
    kernel derives the warp's lerp coefficients from ``positions`` itself
    (``warp_coeffs``' arithmetic), so this launches only the kernel and
    allocates only its output."""
    b, h, w, c = left.shape
    if right.shape != left.shape or right.dtype != left.dtype:
        raise ValueError(
            f"left {tuple(left.shape)} {left.dtype} and right "
            f"{tuple(right.shape)} {right.dtype} must match")
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    supported = (torch.float32, torch.bfloat16)
    if left.dtype not in supported or out_dtype not in supported:
        raise TypeError(
            f"gwc_warp kernel takes fp32/bf16, got {left.dtype} -> "
            f"{out_dtype}")
    if positions.dim() != 2 or positions.shape[0] != b:
        raise ValueError(f"positions {tuple(positions.shape)} are not "
                         f"[{b}, K]")
    num_out = positions.shape[1]
    left, right = left.contiguous(), right.contiguous()
    positions = positions.float().contiguous()
    out = torch.empty((b, num_out, h, w, num_groups), dtype=out_dtype,
                      device=left.device)
    _build.launch(
        "gwc_warp", left.get_device(), left.data_ptr(), right.data_ptr(),
        positions.data_ptr(), out.data_ptr(), b, h, w, c, num_groups,
        num_out, max_disp, int(left.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16))
    return out


class GwcWarp(torch.autograd.Function):
    """``forward(left, right, positions, max_disp, num_groups, out_dtype,
    impl)`` runs ``impl`` (K1 or ``gwc_warp_plain``). The backward is the
    JAX package's ``_fused_bwd`` (pallas_gwc.py:217-227): autograd through
    the plain unfused pair in ``out_dtype``, zero for ``positions``."""

    @staticmethod
    def forward(ctx, left, right, positions, max_disp, num_groups, out_dtype,
                impl):
        ctx.save_for_backward(left, right, positions)
        ctx.args = (max_disp, num_groups, out_dtype)
        return impl(left, right, positions, max_disp, num_groups, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        left, right, positions = ctx.saved_tensors
        max_disp, num_groups, out_dtype = ctx.args
        with torch.enable_grad():
            lt = left.detach().requires_grad_()
            rt = right.detach().requires_grad_()
            out = gwc_warp_plain(lt, rt, positions, max_disp, num_groups,
                                 out_dtype)
            dl, dr = torch.autograd.grad(out, (lt, rt), grad)
        return (dl, dr, torch.zeros_like(positions), None, None, None, None)


def fused_gwc_warp(
    left: torch.Tensor,
    right: torch.Tensor,
    positions: torch.Tensor,
    max_disp: int,
    num_groups: int,
    out_dtype=None,
    use_kernel=None,
) -> torch.Tensor:
    """Correlation volume + depth warp in one pass, [B, K, H, W, G],
    differentiable in ``left`` and ``right``.

    left / right: [B, H, W, C] fp32 or bf16; positions: [B, K] fractional
    disparity positions. On a CUDA tensor (``use_kernel`` None or True)
    the forward launches ``csrc/gwc_warp.cu`` or raises; on a CPU tensor it
    runs ``gwc_warp_plain``."""
    out_dtype = out_dtype or left.dtype
    kernel = want_kernel("fused_gwc_warp", use_kernel, left, right,
                         positions, differentiable=True)
    impl = gwc_warp_kernel if kernel else gwc_warp_plain
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (left, right, positions)):
        return GwcWarp.apply(left, right, positions, max_disp, num_groups,
                             out_dtype, impl)
    # nothing to differentiate: no autograd node
    return impl(left, right, positions, max_disp, num_groups, out_dtype)
