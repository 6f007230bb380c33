"""Lightweight KV Abstracts (paper §4.3) and the abstract *pyramid*, ported
from ``repro.core.abstracts``.

An abstract of a KV chunk is the element-wise (min, max) of its key vectors
— two vectors per chunk regardless of chunk size.  The pyramid stacks them
into a segment tree (level *l* merges 2^l base chunks): staying at a coarse
level is the paper's "merge", descending is its "split".  Leaves are f32;
positions past a sequence's length hold the ∓1e30 sentinels (``NEG``), so
they never win a bound and q·sentinel stays finite.

``update_pyramid`` folds one decoded key into its chunk IN PLACE (the port's
decode cache is updated in place, as ``lm.prefill_chunk`` does); the
reference returns new arrays with the same values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

NEG = -1e30  # sentinel for "no key present" (max side); min side uses +1e30


class Pyramid(NamedTuple):
    """Per-level (kmax, kmin); level l tensors: (B, nc0 >> l, Hkv, hd) f32."""

    kmax: Tuple[torch.Tensor, ...]
    kmin: Tuple[torch.Tensor, ...]

    @property
    def levels(self) -> int:
        return len(self.kmax)

    @property
    def base_chunks(self) -> int:
        return self.kmax[0].shape[1]


def num_levels(n_chunks: int, requested: int) -> int:
    """Levels usable for a power-of-two divisible chunk count."""
    lv = 1
    while lv < requested and n_chunks % (1 << lv) == 0 and (n_chunks >> lv) >= 2:
        lv += 1
    return lv


def chunk_minmax(k: torch.Tensor, chunk: int, length=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base-level abstracts.

    k: (B, S, Hkv, hd) roped keys; S % chunk == 0 (the caller pads).
    length: optional valid length (an int, or a (B,) / scalar tensor) —
    positions >= length are masked to the ∓1e30 sentinels so they never
    win a bound."""
    B, S, Hkv, hd = k.shape
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    kc = k.reshape(B, nc, chunk, Hkv, hd).float()
    if length is None:
        return kc.amax(dim=2), kc.amin(dim=2)
    pos = torch.arange(S, device=k.device).reshape(nc, chunk)
    lens = torch.as_tensor(length, device=k.device).reshape(-1, 1, 1)
    valid = (pos[None] < lens)[..., None, None]
    kmax = torch.where(valid, kc, NEG).amax(dim=2)
    kmin = torch.where(valid, kc, -NEG).amin(dim=2)
    return kmax, kmin


def build_pyramid(k: torch.Tensor, chunk: int, levels: int,
                  length=None) -> Pyramid:
    kmax0, kmin0 = chunk_minmax(k, chunk, length)
    levels = num_levels(kmax0.shape[1], levels)
    kmaxs, kmins = [kmax0], [kmin0]
    for _ in range(1, levels):
        km, kn = kmaxs[-1], kmins[-1]
        B, nc, Hkv, hd = km.shape
        kmaxs.append(km.reshape(B, nc // 2, 2, Hkv, hd).amax(dim=2))
        kmins.append(kn.reshape(B, nc // 2, 2, Hkv, hd).amin(dim=2))
    return Pyramid(tuple(kmaxs), tuple(kmins))


def update_pyramid(pyr: Pyramid, k_new: torch.Tensor, pos: int,
                   chunk: int) -> Pyramid:
    """Decode-step update, IN PLACE: fold one new key into its chunk.

    k_new: (B, Hkv, hd) the roped key of the token written at position
    ``pos`` (an int); ``chunk`` is the base chunk size.  Touches one node
    per level — O(levels) work (paper §6.5: abstract maintenance is 1.56 %
    of system overhead).  Returns ``pyr``."""
    k32 = k_new.float()
    pos = int(pos)
    for lvl in range(pyr.levels):
        idx = pos // (chunk << lvl)
        km, kn = pyr.kmax[lvl], pyr.kmin[lvl]
        km[:, idx] = torch.maximum(km[:, idx], k32)
        kn[:, idx] = torch.minimum(kn[:, idx], k32)
    return pyr


def abstract_bytes(pyr: Pyramid) -> int:
    return sum(int(math.prod(a.shape)) * a.element_size()
               for a in (*pyr.kmax, *pyr.kmin))
