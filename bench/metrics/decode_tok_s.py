"""Every output token produced in the window over the window's seconds."""


def read(rec):
    w = rec["window"]
    return w["tokens"] / (w["t_close"] - w["t_open"])
