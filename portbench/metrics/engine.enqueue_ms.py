"""engine.enqueue_ms: mean host ms of `BEVFormerEngine.infer_frame` a frame
of the untraced window, which returns once the frame's work is queued on
the card (the benchmark's host clock around the call; the profiler's
window is not read, since tracing slows the host)."""


def read(ctx):
    spans = [f.enqueue_s for f in ctx.window_frames if f.enqueue_s > 0]
    return 1e3 * sum(spans) / len(spans) if spans else None
