"""The admissions' prefill FLOPs (``bench.costs.prefill_flops`` at each
prompt's length) over their prefill seconds (``admit_profiles``
``prefill_s``) at the H100's bf16 peak, in %, over the admissions that
ended after the window opened (outside the traced stretch)."""


def read(rec):
    c, m, a = rec["costs"], rec["model"], rec["admits"]
    secs = sum(x["prefill_s"] for x in a)
    if not a or secs <= 0:
        return None
    return 100.0 * sum(c.prefill_flops(m, x["S"]) for x in a) \
        / (secs * c.PEAK_BF16_FLOPS)
