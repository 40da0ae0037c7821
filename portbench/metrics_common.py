"""Arithmetic shared by the metric readers."""
from __future__ import annotations

from portbench import roofline, tracing


def family_roofline(rec: dict, family: str):
    """100 x bound / device time of the kernels launched inside the
    family's synchronised call spans; None where the trace holds no such
    call or the card has no entry in the table of peaks."""
    tr = rec["trace"]
    if tr is None or tr["peaks"] is None or family not in tr["work"]:
        return None
    windows = [(t0, t1) for _n, t0, t1 in tracing.spans(tr["events"], f"portbench.call.{family}")]
    kernel_us = tracing.kernel_us_in(tr["events"], windows)
    if kernel_us <= 0:
        return None
    ops, nbytes = tr["work"][family]
    return 100.0 * roofline.bound_s(ops, nbytes, tr["peaks"]) / (kernel_us / 1e6)
