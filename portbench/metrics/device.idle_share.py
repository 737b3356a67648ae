"""device.idle_share: % of the traced window in which no operation ran on
the card (one less the union of the device operations' intervals)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t.get("window_s") else None
