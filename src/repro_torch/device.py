"""Explicit device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card.  Raises when CUDA is requested (or
    defaulted to) and absent — the port never drifts onto the CPU; pass
    ``device="cpu"`` to run there deliberately."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch defaults to the CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
