"""Mean host time, in ms, of a decode round's evaluate stage (the bounds
product and the host's chunk selection, ``round_profiles`` ``eval_s``)
over the window's rounds outside the traced stretch."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    return float(np.mean([r["eval_s"] for r in p])) * 1e3 if p else None
