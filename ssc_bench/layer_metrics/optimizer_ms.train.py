"""optimizer_ms.train: device ms a step of the operations launched inside
torch's ``Optimizer.step#AdamW.step`` range (the AdamW update)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not ctx["steps"]:
        return None
    seconds = t.seconds_under("Optimizer.step#AdamW.step")
    return 1e3 * seconds / ctx["steps"] if seconds > 0 else None
