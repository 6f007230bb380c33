"""Mean host time, in ms, of a decode round's appends (``round_profiles``
``append_copy_s + append_store_s``: the new K/V rows' copies to the host,
which wait for the layer's queued work, and the tier store's append) over
the window's rounds outside the traced stretch; None where the program
does not time it."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p or "append_copy_s" not in p[0]:
        return None
    return float(np.mean([r["append_copy_s"] + r["append_store_s"]
                          for r in p])) * 1e3
