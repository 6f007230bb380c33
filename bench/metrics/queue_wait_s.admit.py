"""The median, over the requests due in the window, of the seconds from
the due time to leaving the scheduler's queue (``Request.t_admit``)."""

import numpy as np


def read(rec):
    w, st = rec["window"], rec["stamps"]
    vals = [st.reqs[r].t_admit - st.due[r] for r in w["measured"]
            if st.reqs[r].t_admit is not None]
    return float(np.median(vals)) if vals else None
