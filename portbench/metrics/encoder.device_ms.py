"""encoder.device_ms: device ms a frame of the operations launched inside
the transformer's encoder, over the traced window's frames."""

RANGE = "encoder"


def read(ctx):
    s = ctx.trace.get("ranges", {}).get(RANGE)
    return 1e3 * s / ctx.traced_frames if s and ctx.traced_frames else None
