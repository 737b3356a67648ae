"""engine.frame_p95_ms: the 95th percentile of the latencies of all frames
of the untraced window, a frame from its hand-over to `infer_frame` to its
detections on the host (the benchmark's host clock)."""

import numpy as np


def read(ctx):
    lat = [f.done - f.start for f in ctx.window_frames]
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
