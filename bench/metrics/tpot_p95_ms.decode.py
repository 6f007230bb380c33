"""The decode cell's 95th percentile, in ms, of every gap between two
consecutive output tokens of one session in the window, outside the
traced stretch: a per-layer reading, since its spread from run to run is
wider than an end-to-end bound may be."""

import numpy as np


def read(rec):
    w, st = rec["window"], rec["stamps"]
    tr0, tr1 = rec["traced"]
    gaps = [b - a for r in w["measured"]
            for a, b in zip(st.times[r], st.times[r][1:])
            if b >= w["t_open"] and (b <= tr0 or a >= tr1)]
    if not gaps:
        return None
    return float(np.percentile(gaps, 95)) * 1e3
