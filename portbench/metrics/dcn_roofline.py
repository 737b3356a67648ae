"""dcn_roofline: % of its roofline that the port's DCN operator
(`bevformer_port::modulated_deform_conv2d`) reaches: the least time of a
frame's deformable convolutions at the published H100 peaks
(`roofline.dcn_frame_s`), times the traced frames, over the device time of
the operations launched inside the operator's calls."""

from portbench import roofline

OPERATOR = "bevformer_port::modulated_deform_conv2d"


def read(ctx):
    s = ctx.trace.get("ranges", {}).get(OPERATOR)
    if not s or not ctx.traced_frames:
        return None
    return 100.0 * roofline.dcn_frame_s(ctx.model, ctx.model["dtype"]) * ctx.traced_frames / s
