"""Seconds from the process's start to the window's opening: imports,
weights, the kernel library (built by a checkout's first run), warm-up and
the traffic's own set-up."""


def read(rec):
    return rec["setup_s"]
