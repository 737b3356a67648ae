"""model.mfu: % of the card's published bfloat16 peak (989 TFLOP/s) that the
whole frame reaches: the configuration's FLOPs a frame (the reference's
products, counted by `reference.model.Counter`) times the frames whose
detections reached the host in the untraced window, over its seconds."""

from portbench import roofline


def read(ctx):
    if not ctx.window_frames:
        return None
    flops = ctx.config["flops_per_frame"] * len(ctx.window_frames)
    return 100.0 * flops / ctx.seconds / roofline.PEAK_FLOPS["bfloat16"]
