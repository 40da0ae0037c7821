"""Reading a torch.profiler Chrome trace: the harness's spans, the device's
busy intervals and which kernels ran inside a span.

Spans are the harness's own ``record_function`` ranges (category
``user_annotation``, on the host's clock, which the profiler shares with
the device events).  Device operations are the events of category
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each carries its card in
``args.device`` (else ``pid``).  The union arithmetic is that of
``chip_smoke._busy_ms`` and ``metrics.device_trace``'s readers.
"""
from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def spans(events: list, prefix: str) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of the harness spans whose name starts with prefix."""
    return sorted(
        ((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("name", "").startswith(prefix)),
        key=lambda s: s[1],
    )


def device_ops(events: list, cats=DEVICE_CATS) -> list[tuple[int, str, float, float]]:
    """(card, name, start us, end us) of the device operations."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            dev = e.get("args", {}).get("device", e.get("pid", 0))
            out.append((int(dev), e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of intervals, clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for t0, t1 in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def busy_per_card(events: list, lo: float, hi: float) -> dict[int, float]:
    """{card: busy us in [lo, hi]}."""
    by = {}
    for dev, _name, t0, t1 in device_ops(events):
        by.setdefault(dev, []).append((t0, t1))
    return {dev: union_us(iv, lo, hi) for dev, iv in by.items()}


def launches_found(events: list) -> tuple[int, int]:
    """(kernels whose launch call the trace holds, kernels)."""
    corrs = {e["args"]["correlation"] for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    ks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return sum(e.get("args", {}).get("correlation") in corrs for e in ks), len(ks)


def kernel_us_in(events: list, windows: list[tuple[float, float]]) -> float:
    """Summed duration of the kernels, on any card, launched inside one of
    the windows: a kernel counts by the host time of its launch (the
    runtime or driver call with its correlation id) where the trace holds
    that call, else by its own midpoint (which the device clock's skew
    against the host's can move; each window ends in a synchronisation, so
    a span's kernels have run before it closes)."""
    launch = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch[corr] = float(e["ts"])
    ws = sorted(windows)
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        t = launch.get(e.get("args", {}).get("correlation"), (t0 + t1) / 2)
        if any(a <= t <= b for a, b in ws):
            total += t1 - t0
    return total
