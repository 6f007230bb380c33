"""The 95th percentile, in ms, of every gap between two consecutive output
tokens of one request, over the requests the window measures (a gap
counts once its later token falls at or after the window's opening)."""

import numpy as np


def read(rec):
    w, st = rec["window"], rec["stamps"]
    gaps = [b - a for r in w["measured"]
            for a, b in zip(st.times[r], st.times[r][1:])
            if b >= w["t_open"]]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
