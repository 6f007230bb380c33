"""The window's model FLOPs over the window's seconds at the H100's bf16
peak, in %: each decoded token's matmuls and head (2 x the parameters it
touches) and its attention over the rows its rounds attended.  Over the
rounds and seconds outside the traced stretch."""


def read(rec):
    c, m = rec["costs"], rec["model"]
    per_tok = c.token_matmul_flops(m, logits=True)
    row = c.attn_flops_per_row(m)
    flops = sum(r["B"] * per_tok
                + row * sum(L["rows"] for L in r["layers"].values())
                for r in rec["untraced_rounds"])
    s = rec["untraced_s"]
    return 100.0 * flops / (s * c.PEAK_BF16_FLOPS) if flops and s > 0 \
        else None
