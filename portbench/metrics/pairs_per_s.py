"""pairs_per_s: candidate pairs fully extended a second over the window,
completed passes x candidates / window seconds (host clock; a pass is the
first pass of every candidate and its retries)."""


def read(rec):
    return rec["passes"] * rec["pairs_per_pass"] / rec["window_s"]
