"""serving.queue_ms: mean ms from a frame's submit to the start of the
`step()` that took it, over the untraced window's frames (the benchmark's
host clock).  In a closed loop of as many vehicles as lanes it is the host's
time between steps, and a step's frames a second fall as it grows."""


def read(ctx):
    frames = [f for f in ctx.window_frames if f.queue_s > 0]
    return 1e3 * sum(f.queue_s for f in frames) / len(frames) if frames else None
