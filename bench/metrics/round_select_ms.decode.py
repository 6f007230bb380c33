"""Mean host time, in ms, of a decode round's chunk selection on the host
(``round_profiles`` ``eval_select_s``: the per-sequence selection loop of
evaluate, summed over the layers) over the window's rounds outside the
traced stretch; None where the program does not time it."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p or "eval_select_s" not in p[0]:
        return None
    return float(np.mean([r["eval_select_s"] for r in p])) * 1e3
