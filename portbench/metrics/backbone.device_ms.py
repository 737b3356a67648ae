"""backbone.device_ms: device ms a frame of the operations launched inside
the ResNet and the FPN (from `img_backbone`'s start to `img_neck`'s end), over the traced window's frames."""

RANGE = "backbone"


def read(ctx):
    s = ctx.trace.get("ranges", {}).get(RANGE)
    return 1e3 * s / ctx.traced_frames if s and ctx.traced_frames else None
