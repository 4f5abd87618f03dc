"""msdeform_kernels.serve: the share of the window's 3D deformable
attention calls that launched the program's CUDA kernel, counted as the
program's ``stereoscene.msdeform.kernel`` ranges over its
``stereoscene.msdeform`` ranges opened in the window: 1.0 where every call
took the kernel, 0.0 where every call fell back to the plain gathers. None
where no call opened in the window, or where the program declares no such
kernel span (``utils.spans.SPANS``), as a program without the kernel."""

from stereoscene_torch.utils.spans import SPANS

CALL = "stereoscene.msdeform"
KERNEL = "stereoscene.msdeform.kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or KERNEL not in SPANS:
        return None
    ws, we = trace.window
    opened = [name for name, start, _ in trace.ranges if ws <= start < we]
    calls = opened.count(CALL)
    return opened.count(KERNEL) / calls if calls else None
