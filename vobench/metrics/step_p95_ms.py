"""step_p95_ms (ms), end to end, host clock: the 95th percentile (linear
between ranks) of every unit's latency in the window, each taken by the
host clock from the unit's arrival (in a closed loop, the call) to its
results on the host (``drive.window``)."""

import numpy as np


def read(ctx):
    if not ctx.records.latency_s:
        return None
    return 1e3 * float(np.percentile(ctx.records.latency_s, 95))
