"""serving.lane_fill: % of the serving steps' lanes that held a frame, over
every step of the untraced window (the frames each `step()` returned over its batch)."""


def read(ctx):
    steps = ctx.run.steps
    if not steps:
        return None
    return 100.0 * sum(n for _, _, n in steps) / (len(steps) * int(ctx.params["batch"]))
