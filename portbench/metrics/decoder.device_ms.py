"""decoder.device_ms: device ms a frame of the operations launched inside
the decoder and the head's branches (from the decoder's start to the head's end), over the traced window's frames."""

RANGE = "decoder"


def read(ctx):
    s = ctx.trace.get("ranges", {}).get(RANGE)
    return 1e3 * s / ctx.traced_frames if s and ctx.traced_frames else None
