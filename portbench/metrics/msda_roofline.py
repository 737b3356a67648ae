"""msda_roofline: % of its roofline that the port's MSDA operator
(`bevformer_port::msda`) reaches: the least time of a frame's MSDA work at
the published H100 peaks (`roofline.msda_frame_s`, each camera over the BEV
queries it sees on the rig), times the traced frames, over the device time
of the operations launched inside the operator's calls."""

from portbench import roofline

OPERATOR = "bevformer_port::msda"


def read(ctx):
    s = ctx.trace.get("ranges", {}).get(OPERATOR)
    if not s or not ctx.traced_frames:
        return None
    bound = roofline.msda_frame_s(ctx.model, ctx.visible, ctx.model["dtype"])
    return 100.0 * bound * ctx.traced_frames / s
