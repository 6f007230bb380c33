"""Mean host time, in ms, of a decode round's dense part (``round_profiles``
``dense_s``: the norms, the QKV with qk-norm and RoPE, the attend launch
through the output projection and the MLP, summed over the layers) over
the window's rounds outside the traced stretch; None where the program
does not time it."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p or "dense_s" not in p[0]:
        return None
    return float(np.mean([r["dense_s"] for r in p])) * 1e3
