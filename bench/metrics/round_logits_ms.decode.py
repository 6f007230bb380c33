"""Mean host time, in ms, of a decode round's logits (``round_profiles``
``logits_s``: the final norm and head, the logits' copy to the host and
the argmax) over the window's rounds outside the traced stretch; None
where the program does not time it."""

import numpy as np


def read(rec):
    p = rec["round_profiles"]
    if not p or "logits_s" not in p[0]:
        return None
    return float(np.mean([r["logits_s"] for r in p])) * 1e3
