"""Tiny overrides of the cells, for runs on the CPU: the same code paths
at widths a test run holds (float32, chunk 8, max_len 256)."""

LEOAM = {"chunk_size": 8, "early_chunk_size": 4, "pyramid_levels": 2,
         "min_seq_for_sparse": 32, "sink_chunks": 1, "recent_chunks": 1}

MODEL = {
    "qwen3-1.7b": {"num_hidden_layers": 3, "hidden_size": 64,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "intermediate_size": 128,
                   "vocab_size": 512},
    # four layers at 128 wide: float8 rounding grows past the cell's
    # mean-gap limit here, as it does at full size
    "deepseek-v2-lite-16b": {"num_hidden_layers": 4, "hidden_size": 128,
                             "num_attention_heads": 4,
                             "num_key_value_heads": 4,
                             "intermediate_size": 256, "kv_lora_rank": 64,
                             "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
                             "v_head_dim": 16, "n_routed_experts": 4,
                             "num_experts_per_tok": 2,
                             "moe_intermediate_size": 128,
                             "n_shared_experts": 1, "vocab_size": 512},
}

MIX = {
    "closed": {"prompt_min": 120, "prompt_max": 160, "room": 64,
               "warm_rounds": 2},
    "open": {"rate": 8.0, "n_requests": 24, "prompt_min": 48,
             "prompt_max": 200, "max_new": 16, "warm_s": 0.3,
             "drain_s": 120.0, "sample": 8},
}


def overrides(config: str, kind: str) -> dict:
    return {"model": MODEL[config],
            "port": {"leoam": LEOAM, "dtype": "float32",
                     "engine": {"max_len": 256, "real_codec": True,
                                "prefill_chunk_tokens": 32},
                     "scheduler": {"chunk": 8}},
            "mix": MIX[kind]}
