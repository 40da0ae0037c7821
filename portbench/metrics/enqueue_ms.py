"""enqueue_ms: host-clock time inside DeviceExtender.extend_async (index
upload, routing, launches), summed over a pass, mean over the window's
passes."""


def read(rec):
    return 1e3 * sum(rec["enqueue_s"]) / len(rec["enqueue_s"])
