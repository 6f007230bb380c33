"""PQ abstract plane: the k-means kernel wrappers and the store-facing
helpers (the port of ``repro.kernels.pq.ops``).

``pq_assign`` (B4) and ``pq_update`` (B5) dispatch like every kernel of the
port: a CUDA tensor launches ``csrc/pq_kmeans.cu`` (or the call raises), a
CPU tensor or ``impl="ref"`` takes the plain version in ``ref.py``.
``assign_launches`` and ``update_launches`` count kernel launches only.
On top of them:

* :func:`pq_train` — deterministic online mini-batch k-means.  An
  untrained codebook initializes from strided batch rows and runs a few
  Lloyd iterations; a trained one takes a single running-mean merge
  (``c_k <- (c_k * n_k + sum_batch_k) / (n_k + cnt_batch_k)``).  No RNG
  and no float atomics: two runs over the same ingest order give
  byte-identical codebooks.
* :func:`pq_encode` / :func:`pq_decode` — uint8 codes per (token, kv head)
  key vector; decode is the centroid gather.
* :func:`adc_chunk_scores` — the engine's asymmetric-distance path as
  PyTorch ops on the device: one (B, Hkv, m, K) lookup table per round and
  layer, then a code gather, the sum over subspaces and the per-chunk max.

``pq_train`` and ``pq_encode`` take and return numpy, like the reference;
the k-means runs on ``device`` (the CUDA card unless the caller asks for
the CPU), and only the (m, K) statistics and the codes come back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.pq.ref import (UPDATE_RUN_ROWS, UPDATE_WARPS,
                                        pq_assign_ref, pq_update_ref)

assign_launches = 0
update_launches = 0

SUPPORTED_DSUB = (1, 2, 4, 8, 16, 32)
MAX_CENTROIDS = 256


def _require(ok: bool, name: str, x: torch.Tensor, other: torch.Tensor,
             K: int) -> None:
    """Raise on what the kernel does not take (never run the plain version
    for a CUDA tensor instead)."""
    if not ok:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} {x.dtype}, {tuple(other.shape)} "
            f"{other.dtype} on {other.device}, K={K} is not a supported CUDA "
            f"shape (x (m, N, dsub) with dsub in {SUPPORTED_DSUB}, "
            f"1 <= K <= {MAX_CENTROIDS})")


def pq_assign(x: torch.Tensor, cb: torch.Tensor, *,
              impl: Optional[str] = None) -> torch.Tensor:
    """x: (m, N, dsub); cb: (m, K, dsub) -> codes (m, N) int32, the first
    nearest centroid by ``|c_k|^2 - 2 x . c_k``."""
    if not build.use_kernel(impl, x):
        return pq_assign_ref(x, cb)
    return _assign_kernel(x, cb, None)


def pq_assign_candidates(x: torch.Tensor, cb: torch.Tensor
                         ) -> Tuple[torch.Tensor, float]:
    """:func:`pq_assign` on the card, also returning the mean number of
    centroids per row that the kernel's tensor-core screen left for the
    exact check (1 when the screen alone decides every row)."""
    count = torch.zeros(1, dtype=torch.int64, device=x.device)
    codes = _assign_kernel(x, cb, count)
    return codes, count.item() / max(1, codes.numel())


def _assign_kernel(x: torch.Tensor, cb: torch.Tensor,
                   count: Optional[torch.Tensor]) -> torch.Tensor:
    global assign_launches
    K = cb.shape[1] if cb.dim() == 3 else 0
    _require(x.dim() == 3 and cb.dim() == 3 and x.is_cuda and cb.is_cuda
             and cb.shape[0] == x.shape[0] and cb.shape[2] == x.shape[2]
             and x.shape[2] in SUPPORTED_DSUB and 1 <= K <= MAX_CENTROIDS,
             "pq_assign", x, cb, K)
    m, N, dsub = x.shape
    x = x.float().contiguous()
    cb = cb.float().contiguous()
    codes = torch.empty((m, N), dtype=torch.int32, device=x.device)
    if m == 0 or N == 0:
        return codes
    rc = build.library().leoam_pq_assign(
        x.data_ptr(), cb.data_ptr(), codes.data_ptr(), m, N, K, dsub,
        None if count is None else count.data_ptr(), build.stream_ptr(x))
    build.check(rc, "pq_assign")
    assign_launches += 1
    return codes


def pq_update(x: torch.Tensor, codes: torch.Tensor, n_centroids: int, *,
              impl: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd accumulation: (sums (m, K, dsub), counts (m, K)) f32.  A
    code outside [0, K) adds nothing."""
    if not build.use_kernel(impl, x):
        return pq_update_ref(x, codes, n_centroids)
    global update_launches
    K = int(n_centroids)
    _require(x.dim() == 3 and codes.dim() == 2 and codes.is_cuda
             and tuple(codes.shape) == tuple(x.shape[:2])
             and not codes.dtype.is_floating_point
             and x.shape[2] in SUPPORTED_DSUB and 1 <= K <= MAX_CENTROIDS,
             "pq_update", x, codes, K)
    m, N, dsub = x.shape
    x = build.aligned(x.float())
    codes = codes.to(torch.int32).contiguous()
    dev = x.device
    if m == 0 or N == 0:
        return (torch.zeros((m, K, dsub), dtype=torch.float32, device=dev),
                torch.zeros((m, K), dtype=torch.float32, device=dev))
    sums = torch.empty((m, K, dsub), dtype=torch.float32, device=dev)
    counts = torch.empty((m, K), dtype=torch.float32, device=dev)
    T = -(-N // (UPDATE_RUN_ROWS * UPDATE_WARPS))
    part_sums = torch.empty((m, T, K, dsub), dtype=torch.float32, device=dev)
    part_counts = torch.empty((m, T, K), dtype=torch.int32, device=dev)
    rc = build.library().leoam_pq_update(
        x.data_ptr(), codes.data_ptr(), part_sums.data_ptr(),
        part_counts.data_ptr(), sums.data_ptr(), counts.data_ptr(), m, N, K,
        dsub, T, build.stream_ptr(x))
    build.check(rc, "pq_update")
    update_launches += 1
    return sums, counts


def _subspaces(vecs: np.ndarray, m: int, device: torch.device
               ) -> torch.Tensor:
    """(n, d) vectors -> (m, n, dsub) per-subspace rows (f32) on device."""
    n, d = vecs.shape
    t = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32))
    return t.to(device).reshape(n, m, d // m).permute(1, 0, 2).contiguous()


def _lloyd(x: torch.Tensor, cb: np.ndarray, impl: Optional[str]
           ) -> Tuple[np.ndarray, np.ndarray]:
    """One assign + update pass on the device; the statistics come back
    as f64 numpy."""
    codes = pq_assign(x, torch.from_numpy(cb).to(x.device), impl=impl)
    sums, cf = pq_update(x, codes, cb.shape[1], impl=impl)
    return (sums.cpu().numpy().astype(np.float64),
            cf.cpu().numpy().astype(np.float64))


def pq_train(vecs: np.ndarray, codebook: np.ndarray, counts: np.ndarray, *,
             iters: int = 4, impl: Optional[str] = None,
             device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Online k-means step over one ingest batch.

    vecs: (n, d) raw key vectors; codebook: (m, K, dsub); counts: (m, K)
    running member counts (all-zero == untrained).  Returns the updated
    (codebook f32, counts f64) as numpy, ready for the store's RAM mirror.
    """
    cb = np.asarray(codebook, np.float32).copy()
    cnt = np.asarray(counts, np.float64).copy()
    m, K, _dsub = cb.shape
    n = int(vecs.shape[0])
    if n == 0:
        return cb, cnt
    x = _subspaces(np.asarray(vecs, np.float32), m, resolve_device(device))
    if cnt.sum() == 0:
        # deterministic strided-row init (no RNG); n < K duplicates rows,
        # leaving some clusters empty — they keep their seed value
        idx = (np.arange(K) * max(1, n // K)) % n
        cb = x[:, torch.from_numpy(idx).to(x.device)].cpu().numpy()
        c = np.zeros((m, K), np.float64)
        for _ in range(max(1, iters)):
            sums, c = _lloyd(x, cb, impl)
            nz = c > 0
            cb[nz] = (sums[nz] / c[nz][:, None]).astype(np.float32)
        cnt = c
    else:
        sums, c = _lloyd(x, cb, impl)
        tot = cnt + c
        nz = tot > 0
        merged = (cb.astype(np.float64) * cnt[..., None] + sums)
        cb[nz] = (merged[nz] / tot[nz][:, None]).astype(np.float32)
        cnt = tot
    return cb, cnt


def pq_encode(vecs: np.ndarray, codebook: np.ndarray, *,
              impl: Optional[str] = None,
              device: DeviceLike = None) -> np.ndarray:
    """(n, d) key vectors -> (n, m) uint8 nearest-centroid codes."""
    cb = np.asarray(codebook, np.float32)
    m, K, _dsub = cb.shape
    if K > MAX_CENTROIDS:
        raise ValueError(f"pq_encode: {K} centroids do not fit uint8 codes")
    x = _subspaces(np.asarray(vecs, np.float32), m, resolve_device(device))
    codes = pq_assign(x, torch.from_numpy(cb).to(x.device), impl=impl)
    return np.ascontiguousarray(codes.cpu().numpy().T).astype(np.uint8)


def pq_decode(codes: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """(..., m) uint8 codes -> (..., d) reconstructed vectors (f32)."""
    cb = np.asarray(codebook, np.float32)
    m, _K, dsub = cb.shape
    flat = np.asarray(codes).reshape(-1, m).astype(np.int64)
    out = cb[np.arange(m)[None, :], flat]                 # (N, m, dsub)
    return out.reshape(np.asarray(codes).shape[:-1] + (m * dsub,))


def adc_chunk_scores(q_sum: torch.Tensor, codebook, codes, lengths
                     ) -> torch.Tensor:
    """Asymmetric-distance chunk scores off PQ codes, on q_sum's device.

    q_sum: (B, Hkv, hd) group-summed pre-scaled queries; codebook:
    (m, K, dsub); codes: (B, nc, chunk, Hkv, m) uint8; lengths: (B,) live
    token counts (tokens at or past a sequence's length are masked out of
    the max).  The last three may be numpy.  Returns (B, Hkv, nc) f32 —
    the layout of the bounds product's ub."""
    q_sum = q_sum.float()
    dev = q_sum.device
    cb = torch.as_tensor(codebook, dtype=torch.float32, device=dev)
    codes = torch.as_tensor(codes, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    B, Hkv, _hd = q_sum.shape
    m, _K, dsub = cb.shape
    nc, chunk = codes.shape[1], codes.shape[2]
    lut = torch.einsum("bhmd,mkd->bhmk",
                       q_sum.reshape(B, Hkv, m, dsub), cb)  # (B,Hkv,m,K)
    idx = codes.long().permute(0, 3, 4, 1, 2).reshape(B, Hkv, m, nc * chunk)
    vals = torch.gather(lut, 3, idx)                      # (B,Hkv,m,nc*chunk)
    tok = vals.sum(2).reshape(B, Hkv, nc, chunk)
    pos = torch.arange(nc * chunk, device=dev).reshape(nc, chunk)
    live = pos[None] < lengths.long()[:, None, None]      # (B, nc, chunk)
    tok = torch.where(live[:, None], tok, float("-inf"))
    return tok.amax(-1)                                   # (B, Hkv, nc)
