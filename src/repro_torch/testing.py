"""Helpers that hold ``lm.decode_step`` on the card against its plain run.

Two context managers, used by ``chip_smoke.py`` and the card tests:

* :func:`replay_selections` — one run records the chunk ids each sparse
  layer's ``pyramid_select_gqa`` picks; a second run replays them, so the
  two runs attend the same chunks and their logits can be compared where
  near-equal chunk bounds would otherwise pick other chunks;
* :func:`check_decode_kernels` — every call of kernel B1's two entries
  and of B2's contract entry that launches its kernel is run again
  through its plain version on the same inputs, and the agreement of the
  two is recorded.  The plain calls launch no kernel, so the launch
  counts stay those of the path.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

TOL_BOUNDS_REL = 1e-5        # B1: f32 sums in another order
TOL_TRIPLE_REL = 1e-5        # B2's m and den: f32 sums in another order
SENTINEL_ABS = 1e20          # a bound this large comes from a ±1e30 box


@contextlib.contextmanager
def replay_selections(record: Optional[list] = None,
                      replay: Optional[list] = None,
                      pairs: Optional[list] = None):
    """Inside the block ``sparse_attention.pyramid_select_gqa`` (each
    sparse layer's chunk selection in ``lm.decode_step``) appends its ids
    to ``record``; or, with ``replay``, runs as usual (B1 still launches)
    and returns the recorded ids in order instead, its own ids appended
    to ``pairs`` beside them as ``(own, replayed)``."""
    from repro_torch.core import sparse_attention as sa
    own = sa.pyramid_select_gqa
    it = iter(replay) if replay is not None else None

    def select(*a, **kw):
        ids = own(*a, **kw)
        if it is None:
            record.append(ids)
            return ids
        want = next(it)
        if pairs is not None:
            pairs.append((ids, want))
        return want

    sa.pyramid_select_gqa = select
    try:
        yield
    finally:
        sa.pyramid_select_gqa = own


def bounds_agreement(got, want) -> Dict[str, float]:
    """B1's (ub, lb) against its plain version's: the largest difference
    relative to the larger of the element's own magnitude and the largest
    bound of a live chunk (one whose box holds a key: below
    ``SENTINEL_ABS``), and whether every bound is finite."""
    rel, finite = 0.0, True
    for g, w in zip(got, want):
        finite = finite and bool(torch.isfinite(g).all())
        wa = w.abs()
        live = wa[wa < SENTINEL_ABS]
        top = live.max().item() if live.numel() else 0.0
        scale = torch.clamp(wa, min=max(top, 1e-30))
        rel = max(rel, ((g - w).abs() / scale).max().item())
    return {"rel_err": rel, "bar": TOL_BOUNDS_REL, "finite": finite,
            "ok": finite and rel <= TOL_BOUNDS_REL}


def triple_agreement(got, want, v: torch.Tensor, dtype: torch.dtype
                     ) -> Dict[str, float]:
    """B2's (num, den, m) against its plain version's on the same inputs:
    m and den within ``TOL_TRIPLE_REL``, the output num/den within
    :func:`sparse_decode.ref.contract_agreement`'s bar at the model dtype
    ``dtype``, every value finite."""
    from repro_torch.kernels.sparse_decode.ref import contract_agreement
    (nk, dk, mk), (nr, dr, mr) = got, want
    finite = all(bool(torch.isfinite(t).all()) for t in (nk, dk, mk))
    err, bar = contract_agreement(nk / dk[..., None], nr / dr[..., None], v,
                                  dr, dtype)
    tri = max(((dk - dr).abs() / dr.abs().clamp(min=1.0)).max().item(),
              ((mk - mr).abs() / mr.abs().clamp(min=1.0)).max().item())
    return {"err": err, "bar": bar, "triple_rel_err": tri,
            "finite": finite,
            "ok": finite and err <= bar and tri <= TOL_TRIPLE_REL}


@contextlib.contextmanager
def check_decode_kernels(out: Dict[str, List[dict]]):
    """Inside the block each kernel call of ``chunk_bounds`` (B1's
    contract entry: gathered pyramid boxes), ``chunk_bounds_gqa`` (B1 on
    a cache leaf's boxes) and ``sparse_decode`` (B2's contract entry) is
    followed by its plain version on the same inputs; the agreement
    (:func:`bounds_agreement`, :func:`triple_agreement`) is appended to
    ``out[name]``.  Calls that ask for the plain version pass through."""
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.sparse_decode import ops as sd
    saved = {(cb, "chunk_bounds"): cb.chunk_bounds,
             (cb, "chunk_bounds_gqa"): cb.chunk_bounds_gqa,
             (sd, "sparse_decode"): sd.sparse_decode}

    def wrap(name, fn):
        def checked(q, *a, impl=None, **kw):
            res = fn(q, *a, impl=impl, **kw)
            if build.use_kernel(impl, q):
                ref = fn(q, *a, impl="ref", **kw)
                if name == "sparse_decode":
                    k, v = a[0], a[1]
                    tm = q.dtype if q.dtype == k.dtype else torch.float32
                    row = triple_agreement(res, ref, v, tm)
                else:
                    row = bounds_agreement(res, ref)
                out.setdefault(name, []).append(row)
            return res
        return checked

    for (mod, name), fn in saved.items():
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
