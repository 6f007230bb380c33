"""Mean seconds of an admission's prefill (``admit_profiles`` ``prefill_s``)
over the admissions that ended after the window opened (outside the
traced stretch)."""

import numpy as np


def read(rec):
    a = rec["admits"]
    return float(np.mean([x["prefill_s"] for x in a])) if a else None
