"""setup_s: seconds from the end of traffic generation to the window's
start: the program's import and kernel builds (first run in a checkout),
the reads' upload, the engine's build and the warm passes."""


def read(rec):
    return rec["setup_s"]
