"""images_replays.serve: replays of the image backbone's CUDA graph a
traced frame, counted as the program's ``stereoscene.images.replay``
ranges opened in the window (1.0 where every frame replays it). None
where the program opens no such range, as where it launches the backbone
operation by operation."""

REPLAY = "stereoscene.images.replay"


def read(ctx):
    trace, frames = ctx.get("trace"), ctx.get("frames")
    if trace is None or not frames:
        return None
    ws, we = trace.window
    replays = sum(1 for name, start, _ in trace.ranges
                  if name == REPLAY and ws <= start < we)
    return replays / frames if replays else None
