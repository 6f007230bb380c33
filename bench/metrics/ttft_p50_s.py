"""The median, over every request due in the window, of the seconds from
its due time to its first token.  A request that failed, or had no first
token when the drain ended, counts as missing (slower than any)."""

import math

import numpy as np


def read(rec):
    w, st = rec["window"], rec["stamps"]
    vals = []
    for r in w["measured"]:
        ts = st.times[r]
        ok = ts and st.reqs[r].error is None
        vals.append(ts[0] - st.due[r] if ok else math.inf)
    if not vals:
        return None
    med = float(np.median(vals))
    return med if math.isfinite(med) else None
