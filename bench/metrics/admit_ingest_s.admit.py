"""Mean seconds an admission spent handing its layers to the tier store
(``admit_profiles`` ``ingest_s``) over the admissions that ended after the
window opened (outside the traced stretch)."""

import numpy as np


def read(rec):
    a = rec["admits"]
    return float(np.mean([x["ingest_s"] for x in a])) if a else None
