"""device_idle_pct: 100 x (1 - busy / wall) over the traced whole passes,
busy the union of kernel, copy and fill intervals of each card, mean over
the cell's cards."""


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    lo, hi = tr["window_us"]
    busy = sum(tr["busy_us"]) / len(tr["busy_us"])
    return 100.0 * (1.0 - busy / (hi - lo))
