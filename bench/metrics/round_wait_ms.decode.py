"""Mean host time, in ms, a decode round waited on other threads
(``round_profiles`` ``eval_wait_s + lock_wait_s``: the prefetch worker's
futures and the blocked acquires of the store lock) over the window's
rounds outside the traced stretch; None where the program does not time
it."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p or "eval_wait_s" not in p[0]:
        return None
    return float(np.mean([r["eval_wait_s"] + r["lock_wait_s"]
                          for r in p])) * 1e3
