"""pass_p95_ms: 95th percentile of one pass's host-clock time over the
window's passes, from the first launch to the last answer on the host."""
import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec["pass_s"]) * 1e3, 95))
