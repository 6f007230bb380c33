"""Mean host time, in ms, of a decode round's transfer stage (the tier
store's disk gather and the pool upload, ``gather_s + upload_s``) over the
window's rounds outside the traced stretch."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p:
        return None
    return float(np.mean([r["gather_s"] + r["upload_s"] for r in p])) * 1e3
