"""Kernel B1 (chunk bounds) in the traced rounds: the sum of each call's
bound (the larger of its bytes at 3.35 TB/s and its operations at the f32
peak, ``bench.costs.b1_cost`` at the call's shapes) over the sum of B1's
device time in the profiler trace, in %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["kernel_s"]["b1"]:
        return None
    c, m = rec["costs"], rec["model"]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["head_dim"]
    bound = sum(c.bound_s(*c.b1_cost(L["B"], H, hd, L["nc"], Hkv, 2),
                          c.B1_PEAK)
                for r in tr["rounds"] for L in r["layers"].values())
    return 100.0 * bound / tr["kernel_s"]["b1"] if bound else None
