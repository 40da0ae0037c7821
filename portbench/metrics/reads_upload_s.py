"""reads_upload_s: host-clock seconds of DeviceReads.from_arrays and, on a
mesh, the engine's copies of the reads to every card, ending in a sync."""


def read(rec):
    return rec["reads_upload_s"]
