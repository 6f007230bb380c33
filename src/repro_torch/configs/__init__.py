"""Config registry: ``--arch <id>`` resolution.

>>> from repro_torch.configs import get_config, list_configs
>>> cfg = get_config("phi4-mini-3.8b")
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, LeoAMCfg, MLACfg, MambaCfg, MoECfg, RuntimeCfg, ShapeCfg,
    SHAPES, get_shape, smoke_variant, tokens_per_step,
)

# arch id -> module name
_REGISTRY: Dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "nemotron-4-340b": "nemotron4_340b",
    "qwen3-1.7b": "qwen3_1p7b",
    "gemma2-2b": "gemma2_2b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's own evaluation model (LongChat-7B-v1.5-32k, llama arch)
    "longchat-7b-32k": "longchat_7b_32k",
}


def list_configs() -> List[str]:
    return sorted(_REGISTRY)


ASSIGNED = [a for a in sorted(_REGISTRY) if a != "longchat-7b-32k"]


def get_config(name: str, *, smoke: bool = False) -> ArchConfig:
    if name.endswith("-smoke"):
        name, smoke = name[: -len("-smoke")], True
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {list_configs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")
    cfg: ArchConfig = mod.CONFIG
    return smoke_variant(cfg) if smoke else cfg
