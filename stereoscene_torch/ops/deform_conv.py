"""Deformable convolution (DCNv1), 3x3 stride 1 pad 1, channels-last.

Two routes to the same function:

- ``deform_conv2d_plain``, the port of ``stereoscene_tpu/ops/deform_conv.py``:
  per kernel tap, one bilinear gather at the learned offsets and one
  grouped matmul. It is the CPU route and the reference the tests hold
  against the JAX package.
- the z-gather route of ``tools/probe_pallas_dcn.py`` (P1): the gather
  commutes with the channel contraction, so ``dcn_z`` first computes every
  tap's grouped product z_t = x W_t over the whole map (``torch.bmm``, as
  the probe leaves it to XLA), and the gather
  ``out[n] = sum_{t,c} wgt[n, t, c] * z_t[idx[n, t, c]]`` over the four
  bilinear corners of every (pixel, tap) sample runs in the hand-written
  kernel ``csrc/dcn.cu`` (``dcn_gather_kernel``), which derives the corners
  from the offsets itself. Its plain version ``dcn_gather_plain`` builds
  them as tables first (``dcn_corner_tables``, the probe's
  ``corner_tables``).

``deform_conv2d`` picks the route: a CUDA tensor takes the z-gather route
through the ``DeformConv2d`` autograd Function (the kernel launches or
raises); a CPU tensor takes ``deform_conv2d_plain``. The Function's
backward is autograd through ``deform_conv2d_plain``, so the offsets get
their real gradient through the bilinear weights, as JAX's autodiff of its
``deform_conv2d`` gives them; it saves x, offsets and weights, not z.

In bf16 the plain route rounds the bilinear weights to bf16 (as JAX does)
and the z-gather route keeps them in fp32 and rounds z, as the probe does,
so the two agree to bf16 rounding, not bitwise.
"""

from __future__ import annotations

import torch

from .. import _build
from ._dispatch import want_kernel

CORNERS = 4  # bilinear corners per sample: (y0, x0), (y0, x1), (y1, x0), (y1, x1)


def bilinear_sample_nhwc(img: torch.Tensor, y: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Sample [B, H, W, C] at fractional (y, x) [B, Ho, Wo], zero padding
    -> [B, Ho, Wo, C]."""
    b, h, w, c = img.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1 = (y - y0).to(img.dtype)
    wx1 = (x - x0).to(img.dtype)
    y0i, x0i = y0.long(), x0.long()
    flat = img.reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device)[:, None]

    def corner(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        got = flat[bidx, idx].reshape(*yi.shape, c)
        return got * (wgt * inside.to(img.dtype))[..., None]

    out = corner(y0i, x0i, (1 - wy1) * (1 - wx1))
    out = out + corner(y0i, x0i + 1, (1 - wy1) * wx1)
    out = out + corner(y0i + 1, x0i, wy1 * (1 - wx1))
    return out + corner(y0i + 1, x0i + 1, wy1 * wx1)


def _check_groups(cin: int, weights: torch.Tensor, groups: int) -> None:
    _, cing, cout = weights.shape
    if cin % groups or cout % groups or cing * groups != cin:
        raise ValueError(f"bad DCN groups {groups} for {cin}->{cout}")


def deform_conv2d_plain(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weights: torch.Tensor,
    groups: int = 1,
) -> torch.Tensor:
    """3x3 stride-1 pad-1 deformable convolution, gather then matmul.

    x: [B, H, W, Cin]; offsets: [B, H, W, 2*K] (dy, dx) pairs in row-major
    tap order (mmcv DCNv1); weights: [K, Cin // groups, Cout] tap-major;
    returns [B, H, W, Cout]."""
    b, h, w, cin = x.shape
    k, cing, cout = weights.shape
    _check_groups(cin, weights, groups)
    kw = int(round(k ** 0.5))
    dev = x.device
    base_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    base_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    offsets = offsets.float().reshape(b, h, w, k, 2)
    w_g = weights.reshape(k, cing, groups, cout // groups)
    out = None
    for tap in range(k):
        ky, kx = divmod(tap, kw)
        sy = base_y + (ky - (kw - 1) / 2) + offsets[..., tap, 0]
        sx = base_x + (kx - (kw - 1) / 2) + offsets[..., tap, 1]
        sampled = bilinear_sample_nhwc(x, sy, sx).reshape(
            b, h, w, groups, cing)
        y = torch.einsum("bhwgi,igo->bhwgo", sampled, w_g[tap]).reshape(
            b, h, w, cout)
        out = y if out is None else out + y
    return out


def dcn_corner_tables(offsets: torch.Tensor, h: int, w: int):
    """The bilinear corners of every (pixel, tap) sample
    (tools/probe_pallas_dcn.py:52-87 for any B, H, W).

    offsets [B, H, W, 2*K] -> (idx int32, wgt fp32), both [B*H*W, K, 4],
    tap-major then corner: idx is the corner's flat row in [0, B*H*W)
    (clipped into the map, plus the batch offset b*H*W), wgt its bilinear
    weight, zero where the corner lies outside the map. Positions are
    computed in fp32 from ``offsets.float()`` as ``deform_conv2d_plain``
    computes them."""
    b = offsets.shape[0]
    k = offsets.shape[-1] // 2
    kw = int(round(k ** 0.5))
    dev = offsets.device
    off = offsets.float().reshape(b, h, w, k, 2)
    taps = torch.arange(k, device=dev)
    ky = (taps // kw).float() - (kw - 1) / 2
    kx = (taps % kw).float() - (kw - 1) / 2
    base_y = torch.arange(h, dtype=torch.float32, device=dev)
    base_x = torch.arange(w, dtype=torch.float32, device=dev)
    sy = (base_y[None, :, None, None] + ky) + off[..., 0]  # [B, H, W, K]
    sx = (base_x[None, None, :, None] + kx) + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = sy - y0, sx - x0
    y0i, x0i = y0.int(), x0.int()
    boff = (torch.arange(b, device=dev, dtype=torch.int32)
            * (h * w))[:, None, None, None]
    idxs, wgts = [], []
    for dy, dx, wv in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0i + dy, x0i + dx
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idxs.append(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1) + boff)
        wgts.append(wv * inside.float())
    idx = torch.stack(idxs, -1).reshape(b * h * w, k, CORNERS)
    wgt = torch.stack(wgts, -1).reshape(b * h * w, k, CORNERS)
    return idx.int(), wgt


def dcn_z(x: torch.Tensor, weights: torch.Tensor, groups: int) -> torch.Tensor:
    """Every tap's grouped product over the whole map
    (tools/probe_pallas_dcn.py:118-123): x [B, H, W, Cin], weights
    [K, Cin // groups, Cout] -> z [K, B*H*W, Cout] in x's dtype: one
    ``torch.bmm`` over the groups with the taps side by side in N, then one
    copy into the tap-major layout."""
    b, h, w, cin = x.shape
    k, cing, cout = weights.shape
    _check_groups(cin, weights, groups)
    n, cog = b * h * w, cout // groups
    xg = x.reshape(n, groups, cing).transpose(0, 1)  # [G, N, Cing]
    wg = (weights.to(x.dtype).reshape(k, cing, groups, cog)
          .permute(2, 1, 0, 3).reshape(groups, cing, k * cog))
    z = torch.bmm(xg, wg).view(groups, n, k, cog)  # [G, N, K, Cog]
    return z.permute(2, 1, 0, 3).reshape(k, n, cout)


def dcn_gather_plain(z: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The plain version of P1: ``sum_{t,c} wgt[:, t, c] * z[t, idx[:, t,
    c]]`` over z [K, B*H*W, C] and the corner tables of offsets
    [B, H, W, 2*K] (``dcn_corner_tables``), accumulated in fp32 and cast
    once to z's dtype -> [B*H*W, C]."""
    k, n, c = z.shape
    idx, wgt = dcn_corner_tables(offsets, *offsets.shape[1:3])
    out = torch.zeros(n, c, dtype=torch.float32, device=z.device)
    for t in range(k):
        rows = z[t][idx[:, t].long()].float()  # [N, 4, C]
        out += (rows * wgt[:, t, :, None]).sum(1)
    return out.to(z.dtype)


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` contiguous at an address the kernel's vector loads can take."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % nbytes else t


def dcn_gather_kernel(z: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/dcn.cu`` (P1) on CUDA tensors or raise: z [K, B*H*W,
    C] fp32 or bf16 with C a multiple of 16 bytes' worth and K = kw * kw
    <= 9, offsets [B, H, W, 2*K] (read as fp32) -> [B*H*W, C] in z's
    dtype."""
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dcn_gather kernel takes fp32/bf16 z, got {z.dtype}")
    if not offsets.is_floating_point():
        raise TypeError(f"dcn_gather kernel takes float offsets, got "
                        f"{offsets.dtype}")
    if z.dim() != 3 or offsets.dim() != 4:
        raise ValueError(f"dcn_gather kernel: z {tuple(z.shape)} and offsets "
                         f"{tuple(offsets.shape)} are not [K, N, C] / "
                         "[B, H, W, 2K]")
    k, n, c = z.shape
    b, h, w, two_k = offsets.shape
    kw = int(round(k ** 0.5))
    if two_k != 2 * k or b * h * w != n:
        raise ValueError(f"dcn_gather kernel: offsets {tuple(offsets.shape)} "
                         f"do not match z {tuple(z.shape)}")
    vec = 16 // z.element_size()
    if c % vec or kw * kw != k or not 1 <= k <= 9 or n == 0:
        raise ValueError(f"dcn_gather kernel takes C % {vec} == 0, K a square "
                         f"<= 9 and N > 0, got C {c}, K {k}, N {n}")
    if not (z.is_cuda and offsets.device == z.device):
        raise ValueError("dcn_gather kernel: z and the offsets must be on one "
                         "card")
    z, offsets = _aligned(z, 16), _aligned(offsets.float(), 8)
    out = torch.empty((n, c), dtype=z.dtype, device=z.device)
    lib = _build.load_kernels()
    with torch.cuda.device(z.device):  # launch on the tensors' card
        _build.check(lib.stereoscene_dcn_gather(
            z.data_ptr(), offsets.data_ptr(), out.data_ptr(), n, c, h, w, kw,
            int(z.dtype == torch.bfloat16), _build.stream_ptr(z.device),
        ), "stereoscene_dcn_gather")
    _build.launch_counts["dcn_gather"] += 1
    return out


class DeformConv2d(torch.autograd.Function):
    """``forward(x, offsets, weights, groups)``: z, then the gather, the
    P1 kernel on a CUDA tensor and ``dcn_gather_plain`` on a CPU one. The
    backward is autograd through ``deform_conv2d_plain``, offsets
    included."""

    @staticmethod
    def forward(ctx, x, offsets, weights, groups):
        ctx.save_for_backward(x, offsets, weights)
        ctx.groups = groups
        b, h, w, _ = x.shape
        z = dcn_z(x, weights, groups)
        gather = dcn_gather_kernel if z.is_cuda else dcn_gather_plain
        return gather(z, offsets).view(b, h, w, -1)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            out = deform_conv2d_plain(*ins, groups=ctx.groups)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad))
        grads = [next(got) if need else None for need in needs]
        return (*grads, None)


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weights: torch.Tensor,
    groups: int = 1,
    use_kernel=None,
) -> torch.Tensor:
    """3x3 stride-1 pad-1 deformable convolution, differentiable in x,
    offsets and weights (shapes as ``deform_conv2d_plain``).

    On a CUDA tensor (``use_kernel`` None or True) the forward is the
    z-gather route with the P1 kernel, which launches or raises; on a CPU
    tensor it is ``deform_conv2d_plain``."""
    if want_kernel("deform_conv2d", use_kernel, x, offsets, weights,
                   differentiable=True):
        return DeformConv2d.apply(x, offsets, weights, groups)
    return deform_conv2d_plain(x, offsets, weights, groups)
