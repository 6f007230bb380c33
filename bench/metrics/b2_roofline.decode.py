"""Kernel B2 (sparse decode attention over the pool slots) in the traced
rounds: the sum of each call's bound (``bench.costs.b2_pooled_cost`` at
the call's batch, its padded selection width and the live rows its
selections hold) over the sum of B2's device time (both of its kernels) in
the profiler trace, in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["kernel_s"]["b2"]:
        return None
    c, m = rec["costs"], rec["model"]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["head_dim"]
    bound = sum(c.bound_s(*c.b2_pooled_cost(L["B"], H, Hkv, hd,
                                            L["live_rows"], L["nsel"], 2),
                          c.B2_PEAK)
                for r in tr["rounds"] for L in r["layers"].values())
    return 100.0 * bound / tr["kernel_s"]["b2"] if bound else None
