"""The share, in %, of the traced window in which no kernel, copy or fill
ran on the device (torch.profiler)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
