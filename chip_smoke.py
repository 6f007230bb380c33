#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card.  Phases, in order; any failure exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
3. per kernel, at the main path's shapes: kernel against its plain
   PyTorch version (max error beside the stated tolerance), the time of
   the kernel, of the plain version and of a PyTorch library call doing
   the same work where one exists, and the least time the card could take;
   B2 also at longchat's own 32k context, and two launches bitwise equal;
   B4's mean candidates per row of its tensor-core screen; B5 bitwise
   equal to its plain version and over two launches, also on phase 3b's
   clustered keys; B3, the fused dequant-and-scatter of a layer's codec
   upload into the pool's slots, at 16 and 48 chunks beside the earlier
   upload (dequant, then an index put), the kernel alone, a fill of as
   many output bytes and the host's packing and copy; the CUDA kernels
   one call launches and when each runs on the device
   (``torch.profiler``); the launch floor (a one-element fill, timed as
   the kernels are);
   3b. the PQ k-means (``pq_train`` + ``pq_encode``) through the kernels
   against the plain versions on clustered keys at one layer's size:
   codebooks, counts and codes byte-identical, and two kernel runs too,
   and B4's candidates on these keys;
4. serve: longchat-7b-32k at full width (32 layers, bf16 random weights
   from a seed) through ContinuousBatcher -> BatchedLeoAMEngine ->
   TieredKVStore, 4 requests of 1536/2048/3072/3584 prompt tokens and 32
   new tokens each; every kernel's launch counter must move;
   4b. the same 4 requests with the PQ abstract plane
   (``EngineCfg(pq_abstracts=True)``): B4 and B5 at ingest, ADC scoring,
   no PQ fallback;
   4c. admission parity: the serve's 1536- and 3584-token prompts, each
   admitted on three fresh engines — ``add_sequence``,
   ``add_sequence_async(...).result()`` and ``begin_admission(...).drain()``
   — and fenced: the overlapped admission must store the synchronous
   one's disk replica and min/max abstracts bit for bit, with the same
   first token; the chunked one's first-token logits must lie within
   ``TOL_E2E_ULPS`` bf16 ulps of the synchronous logits (its replica's
   largest difference is printed); the async admission must have run on
   the ``leoam-admit`` thread and the chunked one in ceil(S / C) steps;
   4d. the 4 requests served again with ``SchedulerCfg(
   overlap_admission=True)``, then with ``chunked_admission=True``: 32
   valid tokens each, B1-B3 launched, every admission in its mode (and the
   chunked serve's ``stats()`` reporting ``chunk_step_ewma_s``), with the
   decode rounds that overlapped an admission timed apart; both at 8 of
   the 32 layers (the early layers and the first body layers, full
   width: a ``[depth]`` line says so) to keep the script in its budget;
   4e. the 4 requests served as in phase 4 with the packed int4 disk
   sidecar (``EngineCfg(disk_sidecar=True)``): every ``kv_replica`` write
   and every disk->host ``kv`` read off the sidecar billed exactly
   ``chunk_bytes * codec_ratio("int4", 64)``; the only fp16 reads are of
   chunks a decode append invalidated (the reference bills those at fp16)
   and none falls back on a failed CRC;
   4f. the 1536- and 3584-token prompts, 16 new tokens, served by the
   engine with ``pooled=False`` (each round's working set uploaded whole,
   B2 over it in place) and with ``pooled=True``, both with
   ``real_codec=False, pipeline=False``: the token streams must be
   identical; the largest logit difference, the legacy round's median and
   upload bytes, and its B1/B2 launches are printed;
   4g. a store-level reopen on the card: one 3584-token sequence of two
   longchat-shaped layers ingested with the sidecar and the real codec,
   fenced, flushed, closed and reopened; every chunk promoted into the
   pool must equal, bit for bit, a CPU store's (``impl="ref"``) after the
   same script;
   4h. the fault domain: the 1536- and 2048-token prompts admitted
   chunked (``begin_admission(...).drain()``) with the packed int4 sidecar
   and the real codec, once with no fault plan and once with explicit
   events: a transient ``disk_read`` error (retried), two ``sidecar_read``
   bitflips (CRC quarantine, fp16 fallback), a ``disk_read`` bitflip on the
   fallback read of a prompt chunk (disk-lost, recomputed from the prompt
   and restored) and a ``worker`` exception in a third, short admission
   (that sequence fails alone); 16 tokens each.  Every restored chunk's
   replica rows must equal the fault-free engine's bit for bit; counters,
   terminal states, leaks and B1-B3 launches are gated; the token streams
   against the fault-free ones, the recovery's wall time and the same
   recovery of a synchronously admitted prompt (its restored replica's
   largest difference from the original: ROADMAP C8) are printed;
   4i. preemption: the 1536- and 2048-token prompts, 16 tokens each, with
   ``real_codec=False, pipeline=False``; the 2048-token sequence suspended
   after round 4 and resumed 4 rounds later, against a run that only
   leaves it out of those rounds: token streams identical, logits bitwise
   equal, pool slots freed on suspend, ``kv_swapout`` billed 0 bytes and
   ``kv_swapin`` the swapped-in chunks' bytes, B1/B2 launched after the
   resume; then the batcher (``max_active=2``, a pressure monitor) serves
   the 1536-, 2048- and 1536-token prompts with the third a high-priority
   request submitted after the first round: one request preempted and
   resumed, all three finished with 16 tokens, nothing leaked;
5. end to end against the plain versions: the first request's prefill and
   two decode rounds with ``impl="ref"``, then with the kernels replaying
   the plain run's chunk selections, logits held to a bf16 tolerance;
6. a ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only b1,b2,b3,b5`` runs phases 1-2 and the timing
lines of the named kernels only (``--b2`` is ``--only b2``), with no
result line; copied into a checkout of another commit, it holds that
commit's kernels against this one's on the same card.
``python3 chip_smoke.py --phases 4h,4i`` runs phases 1-2 and the named
engine phases of phase 4 (4c-4i) only, with their gates and no result
line.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PROMPTS = (1536, 2048, 3072, 3584)
NEW_TOKENS = 32
MAX_LEN = 4096
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32 = 67e12             # f32 outside the tensor cores
PEAK_BF16 = 989e12           # dense bf16 / fp16 tensor cores
PEAK_TF32 = 495e12           # dense TF32 tensor cores
TOL_BOUNDS_REL = 1e-5        # f32 sums in another order
# B2's bf16 output is held by sparse_decode.ref.bf16_agreement: at most 5 %
# of the elements differ, by at most two bf16 ulps of max|ref|.
# End to end, with the same chunk selections, the kernels' rare one-ulp
# differences in attention outputs spread through 32 bf16 layers; the
# logits may differ by this many bf16 ulps of max|logit|
TOL_E2E_ULPS = 4
# B4's codes and B5's sums and counts are bitwise equal to their plain
# versions (B5 adds in the order that pq/ref.py:pq_update_ref repeats), so
# phase 3b's k-means through the kernels gives the plain run's codebooks,
# counts and codes byte for byte.
PQ_M, PQ_K, PQ_DSUB = 16, 256, 8
PQ_KEYS_SEED = 3             # phase 3b's clustered keys (also B5's 2nd line)
PQ_RANDOM_SEED = 4           # B4's and B5's random keys
KERNELS = ("b1", "b2", "b3", "b5")  # what --only may name
# B2 at the serve's lengths halfway through decode, and at longchat's own
# context: 4 sequences near 32k tokens
MAIN_LENGTHS = tuple(p + NEW_TOKENS // 2 for p in PROMPTS)
LONG_MAX_LEN = 32768
LONG_LENGTHS = (31000, 31500, 32000, 32500)
KV_ROOT = ROOT / "build" / "chip_smoke_kv"
# phase 4d's chunked serve: prompt tokens advanced between two rounds
CHUNKED_ROUND_TOKENS = 256
# phase 4f: the legacy full re-upload against the pool, new tokens each
LEGACY_NEW_TOKENS = 16
# phases 4h and 4i: new tokens each, and 4h's third (failing) admission
FAULT_NEW_TOKENS = 16
FAULT_SHORT_PROMPT = 320
# 4h's placement: host tier for chunks 9-14 and disk from chunk 15, so the
# 1536- and 2048-token prompts have prompt chunks on disk (the default
# 0.45 keeps every chunk below 37 on the host)
FAULT_CPU_FRAC = 0.1
# 4i: the 2048-token sequence leaves the batch after this many rounds, for
# this many
PREEMPT_AFTER, PREEMPT_ROUNDS = 4, 4
ENGINE_PHASES = ("4c", "4d", "4e", "4f", "4g", "4h", "4i")  # --phases
# phase 4d's two serves run this many of longchat's 32 layers (its 2 early
# layers and the first body layers, weights and widths unchanged) so that
# the whole script stays inside its time budget
SERVE_MODES_LAYERS = 8
SLEEP_CYCLES = 4_000_000    # ~2 ms at the H100's boost clock


def _time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, each launched into a cold L2 (a 256
    MiB buffer is rewritten between calls, outside the timed window) and
    behind a device-side sleep that outlasts the host's enqueue."""
    import torch
    for _ in range(warmup):
        fn()
    evs = []
    for _ in range(iters):
        flush.zero_()
        # keep the card busy while the host enqueues the call, so the
        # events time the device work and not the Python launch overhead
        torch.cuda._sleep(SLEEP_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def b1_inputs(torch):
    """B1's operands at the evaluate stage's shape: q (B, H, hd) bf16, the
    engine's dtype, against (B, nc, Hkv, hd) f32 abstracts of the serve's
    lengths halfway through decode, from a seeded generator."""
    dev = torch.device("cuda")
    B, H, hd, chunk = len(PROMPTS), 32, 128, 64
    nc = max(-(-int(L) // chunk) for L in MAIN_LENGTHS)
    g = torch.Generator(device=dev).manual_seed(1)
    q = (torch.randn(B, H, hd, device=dev, generator=g)
         / math.sqrt(hd)).bfloat16()
    km = torch.randn(B, nc, H, hd, device=dev, generator=g)
    kn = km - torch.randn(B, nc, H, hd, device=dev, generator=g).abs()
    return q, km, kn


def b1_row(torch, flush):
    """B1 against its plain version at :func:`b1_inputs`' shape."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    q, km, kn = b1_inputs(torch)
    B, nc, H, hd = km.shape
    ub_k, lb_k = cb.chunk_bounds_gqa(q, km, kn)
    ub_r, lb_r = cb.chunk_bounds_gqa(q, km, kn, impl="ref")
    err = max((ub_k - ub_r).abs().max().item(), (lb_k - lb_r).abs().max().item())
    tol = TOL_BOUNDS_REL * max(ub_r.abs().max().item(), lb_r.abs().max().item())
    qf = q.float().reshape(B, H, 1, hd)
    qp, qn = qf.clamp(min=0), qf.clamp(max=0)
    kmt, knt = km.transpose(1, 2), kn.transpose(1, 2)
    nbytes = _nbytes(q, km, kn, ub_r, lb_r)
    ops = 8 * B * H * nc * hd
    return dict(
        max_abs_err=err, tol=tol,
        ms=_time_ms(lambda: cb.chunk_bounds_gqa(q, km, kn), flush),
        plain_ms=_time_ms(lambda: cb.chunk_bounds_gqa(q, km, kn, impl="ref"),
                          flush),
        library_ms=_time_ms(lambda: torch.einsum("bkgd,bkcd->bkgc", qp, kmt)
                            + torch.einsum("bkgd,bkcd->bkgc", qn, knt), flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: cb.chunk_bounds_gqa(q, km, kn), flush),
        bound=(nbytes / HBM_BYTES_S, ops / PEAK_F32),
        shape=f"q {tuple(q.shape)} bf16, abstracts {tuple(km.shape)} f32")


def _cuda_kernels_per_call(torch, fn, flush, reps: int = 3,
                           attempts: int = 12):
    """The CUDA kernels that one call of ``fn`` launches, in launch order,
    each with its start and end on the device in us after the first one's
    start (a dependent launch starts before its predecessor ends): read by
    torch.profiler after a warm-up, each call into a cold L2 as in
    :func:`_time_ms`, the mean of ``reps`` traces that list the same
    kernels.  A trace in which the profiler caught no device activity is
    taken again, up to ``attempts`` calls; an error of ``fn`` propagates.
    [(name, start_us, end_us), ...]."""
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    runs, names = [], []
    for _ in range(attempts):
        flush.zero_()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if e.device_type == cuda),
                     key=lambda e: e.time_range.start)
        if evs:
            t0 = evs[0].time_range.start
            runs.append([(re.sub(r"^void ", "", e.name).split("<")[0]
                          .split("(")[0].strip(), e.time_range.start - t0,
                          e.time_range.end - t0) for e in evs])
            names.append([n for n, _, _ in runs[-1]])
        if names and names.count(max(names, key=names.count)) >= reps:
            break
    else:
        raise SystemExit(f"chip_smoke: the profiler traced {len(runs)} "
                         f"calls in {attempts} with device kernels, not "
                         f"{reps} alike: {names}")
    common = max(names, key=names.count)
    runs = [r for r, n in zip(runs, names) if n == common][:reps]
    return [(n, sum(r[i][1] for r in runs) / reps,
             sum(r[i][2] for r in runs) / reps)
            for i, n in enumerate(common)]


def launch_floor_ms(torch, flush) -> float:
    """The time of a launch whose one block returns at once (a one-element
    fill), timed as every kernel is: the floor under each ``ms``."""
    t = torch.empty(1, device="cuda")
    return _time_ms(t.zero_, flush)


def b2_row(np, torch, rng, flush, lengths, max_len, chunk=64, rate=0.10):
    """B2 against its plain version on 4 sequences of ``lengths`` tokens of
    a ``max_len`` context: the tree's selection at ``rate`` plus chunk 0,
    the last two chunks and 5 % of the context's chunks as hot ones, as
    the engine would select them; the pool holds every chunk of the
    context.  Also checks that two launches are bitwise equal."""
    import torch.nn.functional as F
    from repro_torch.core.adaptive import tree_select_chunks
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.kernels.sparse_decode.ref import bf16_agreement

    dev = torch.device("cuda")
    B, H, hd = len(lengths), 32, 128
    sels = []
    for L in lengths:
        nv = -(-int(L) // chunk)
        sel, _ = tree_select_chunks(rng.rand(nv), int(L),
                                    max(chunk, math.ceil(L * rate)), chunk)
        hot = rng.choice(nv, max(1, int(max_len // chunk * 0.05)),
                         replace=False)
        sels.append(sorted(set(sel) | {0} | {nv - 2, nv - 1}
                           | {int(c) for c in hot}))
    nmax = -(-max(len(s) for s in sels) // 4) * 4
    n_slots = B * (max_len // chunk)
    pool = torch.randn(n_slots + 1, 2, chunk, H, hd,
                       device=dev).to(torch.float16)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    for b, s in enumerate(sels):
        slots[b, :len(s)] = rng.choice(n_slots, len(s), replace=False)
        cids[b, :len(s)] = s
    slots_t = torch.from_numpy(slots).to(dev)
    cids_t = torch.from_numpy(cids).to(dev)
    len_t = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    qd = torch.randn(B, H, hd, device=dev).bfloat16()
    k_new = torch.randn(B, 1, H, hd, device=dev).bfloat16()
    v_new = torch.randn(B, 1, H, hd, device=dev).bfloat16()
    args = (qd, pool, slots_t, cids_t, len_t, k_new, v_new, None)
    o_k = sd.sparse_decode_pooled(*args)
    o_k2 = sd.sparse_decode_pooled(*args)
    o_r = sd.sparse_decode_pooled(*args, impl="ref")
    err, tol, mismatch = bf16_agreement(o_k, o_r)
    n_live = int((cids >= 0).sum())

    def sdpa():
        kv = pool[slots_t.long()]                      # (B, nmax, 2, c, H, hd)
        kk = torch.cat([kv[:, :, 0].reshape(B, -1, H, hd).bfloat16(), k_new],
                       1).transpose(1, 2)
        vv = torch.cat([kv[:, :, 1].reshape(B, -1, H, hd).bfloat16(), v_new],
                       1).transpose(1, 2)
        pos = (cids_t.long()[..., None] * chunk
               + torch.arange(chunk, device=dev)).reshape(B, -1)
        ok = (cids_t[..., None] >= 0).expand(B, nmax, chunk).reshape(B, -1) \
            & (pos < len_t[:, None])
        mask = torch.cat([ok, torch.ones(B, 1, dtype=torch.bool, device=dev)],
                         1)[:, None, None]
        return F.scaled_dot_product_attention(qd[:, :, None], kk, vv,
                                              attn_mask=mask)

    # every live row of K and V read once (the tail chunk only to length)
    live_rows = sum(min(chunk, int(L) - c * chunk) for L, s in
                    zip(lengths, sels) for c in s)
    nbytes = (live_rows * 2 * H * hd * 2 + _nbytes(qd, k_new, v_new, o_r)
              + _nbytes(slots_t, cids_t, len_t))
    ops = 4 * H * hd * (live_rows + B)
    plan = (sd.split_plan(nmax, B, H) if hasattr(sd, "split_plan")
            else None)
    row = dict(
        max_abs_err=err, tol=tol, mismatch=mismatch,
        bitwise=bool(torch.equal(o_k, o_k2)),
        ms=_time_ms(lambda: sd.sparse_decode_pooled(*args), flush),
        plain_ms=_time_ms(lambda: sd.sparse_decode_pooled(*args, impl="ref"),
                          flush),
        library_ms=_time_ms(sdpa, flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: sd.sparse_decode_pooled(*args), flush),
        bound=(nbytes / HBM_BYTES_S, ops / PEAK_BF16),
        shape=f"B={B} lengths={list(map(int, lengths))} nmax={nmax} live "
              f"chunks={n_live} live rows={live_rows} chunk={chunk} "
              f"H=Hkv={H} hd={hd} (nsplit, chunks per split)={plan}")
    del pool
    torch.cuda.empty_cache()
    return row


def phase_kernels(np, torch, rng):
    """Each kernel against its plain version at the main path's shapes,
    and B2 once more at longchat's own 32k context; B3 also at 48
    chunks, about a first round's upload of one layer."""
    from repro_torch.kernels.sparse_decode.ref import BF16_MAX_MISMATCH

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    lengths = np.array(MAIN_LENGTHS, np.int32)
    rows = {}

    rows["chunk_bounds"] = b1_row(torch, flush)

    # --- B2: the selection the tree really produces at these lengths
    rows["sparse_decode"] = b2_row(np, torch, rng, flush, lengths, MAX_LEN)

    # --- B3: a layer's codec upload of 16 chunks into the pool's slots
    slab = b3_slab(torch)
    rows["kv_dequant"] = b3_row(np, torch, flush, slab, 16)
    b3_48 = b3_row(np, torch, flush, slab, 48)
    del slab
    rows.update(_pq_kernel_rows(np, torch, flush))
    clustered = b5_row(torch, *clustered_update_inputs(np, torch), flush)
    long_row = b2_row(np, torch, np.random.RandomState(LONG_MAX_LEN), flush,
                      LONG_LENGTHS, LONG_MAX_LEN)
    print(f"[kernel] launch floor: one-element fill ms="
          f"{launch_floor_ms(torch, flush)!r}")
    del flush
    torch.cuda.empty_cache()
    print_row("sparse_decode at 32k", long_row)
    print_row("pq_update on clustered keys", clustered)
    print_row("kv_dequant at 48 chunks", b3_48)
    for name, r in rows.items():
        print_row(name, r)
    bad = [n for n, r in {**rows, "sparse_decode at 32k": long_row,
                          "pq_update on clustered keys": clustered,
                          "kv_dequant at 48 chunks": b3_48}.items()
           if not r["max_abs_err"] <= r["tol"]
           or not r.get("mismatch", 0.0) <= BF16_MAX_MISMATCH
           or not r.get("bitwise", True) or not r.get("exact", True)]
    if bad:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain "
                         f"versions (or two launches differ): {bad}")
    return rows, long_row, clustered, b3_48


def b3_slab(torch):
    """A pool slab of the serve's size: (4 sequences x 64 chunks + the
    scratch slot, K and V, 64, 32, 128) fp16, the store's dtype."""
    n_slots = len(PROMPTS) * (MAX_LEN // 64)
    return torch.zeros(n_slots + 1, 2, 64, 32, 128, dtype=torch.float16,
                       device="cuda")


def b3_row(np, torch, flush, slab, n):
    """B3 at one layer's codec upload of ``n`` chunks, as the store makes
    it: the K and V planes of seeded fp16 chunks int4-packed on the host
    (``host_pack_ms``: the store's packing and stacking, host clock; then
    ``h2d_ms``: the pageable copy of payload and scales, synchronised)
    and dequantized into ``n`` permuted slots of ``slab``.  ``ms`` is the
    fused call (one launch, after the copy of the slot list);
    ``unfused_ms`` the earlier store's upload on the same inputs:
    ``kv_dequant`` into a fresh tensor, then an index assignment into the
    slab.  A tree without the fused entry times its ``kv_dequant`` plus
    the index assignment as ``ms``.  Two yardsticks beside them:
    ``kernel_ms``, the fused kernel's C entry alone with the slot list
    already on the card (the fused call less its copy of the slots), and
    ``fill_ms``, a fill of as many output bytes.  The plain version runs
    into another copy of the slab, which must come out bitwise equal."""
    from repro_torch.core.compression import quantize_chunks
    from repro_torch.kernels import build
    from repro_torch.kernels.kv_quant import ops as kq
    dev = slab.device
    S, planes, c, H, hd = slab.shape
    rng = np.random.RandomState(100 + n)
    kv = rng.randn(n, planes, c, H, hd).astype(np.float16)
    kv[:, 1] *= 0.5                                  # V apart from K

    def pack():
        pk = [quantize_chunks(kv[:, pl], "int4") for pl in range(planes)]
        return (torch.from_numpy(np.concatenate([d for d, _ in pk])),
                torch.from_numpy(np.concatenate([s for _, s in pk])))

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        data_h, scale_h = pack()
        times.append(time.perf_counter() - t0)
    host_pack_ms = sorted(times)[2] * 1e3
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data, scale = data_h.to(dev), scale_h.to(dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    h2d_ms = sorted(times)[2] * 1e3
    slots = rng.permutation(S - 1)[:n].tolist()
    fused = hasattr(kq, "kv_dequant_scatter")

    def unfused(impl=None):
        out = kq.kv_dequant(data, scale, codec="int4",
                            out_dtype=torch.float16, impl=impl)
        idx = torch.from_numpy(np.asarray(slots, np.int64)).pin_memory().to(
            dev, non_blocking=True)
        slab[idx] = out.reshape(planes, n, c, H, hd).transpose(0, 1)

    if fused:
        call = lambda: kq.kv_dequant_scatter(data, scale, slab, slots,
                                             codec="int4")
        plain = lambda: kq.kv_dequant_scatter(data, scale, slab, slots,
                                              codec="int4", impl="ref")
        slots_dev = torch.tensor(slots, dtype=torch.int64, device=dev)

        def kernel_alone():
            build.check(build.library().leoam_kv_dequant_scatter(
                data.data_ptr(), scale.data_ptr(), slab.data_ptr(),
                slots_dev.data_ptr(), n, planes, c, H * hd, 4,
                build.DTYPE_CODES[slab.dtype], planes * c * H * hd,
                kq.access_width("int4", data, scale, slab),
                build.stream_ptr(data)), "kv_dequant_scatter")
    else:
        call, plain = unfused, lambda: unfused("ref")
    slab.normal_()
    sentinel = slab.clone()
    call()
    first = slab.clone()
    slab.copy_(sentinel)
    call()
    bitwise = bool(torch.equal(slab, first))
    slab.copy_(sentinel)
    plain()
    err = (first.float() - slab.float()).abs().max().item()
    exact = bool(torch.equal(first, slab))
    del first, sentinel
    nbytes = _nbytes(data, scale) + n * planes * c * H * hd * 2 + n * 8
    ms = _time_ms(call, flush)
    out_rows = slab[:n]
    return dict(
        max_abs_err=err, tol=0.0, exact=exact, bitwise=bitwise, ms=ms,
        plain_ms=_time_ms(plain, flush), library_ms=None,
        unfused_ms=_time_ms(unfused, flush) if fused else ms,
        kernel_ms=_time_ms(kernel_alone, flush) if fused else None,
        fill_ms=_time_ms(out_rows.zero_, flush),
        host_pack_ms=host_pack_ms, h2d_ms=h2d_ms,
        cuda_per_call=_cuda_kernels_per_call(torch, call, flush),
        bound=(nbytes / HBM_BYTES_S, n * planes * c * H * hd / PEAK_F32),
        shape=f"{n} chunks x K,V of c={c} d={H * hd} int4 -> fp16 into "
              f"{n} permuted slots of a ({S}, {planes}, {c}, {H}, {hd}) "
              f"slab; {'fused' if fused else 'kv_dequant + index put'}")


def print_row(name, r):
    """One ``[kernel]`` line: the agreement with the plain version, the
    CUDA kernels a call launches, and the times beside the bound."""
    from repro_torch.kernels.sparse_decode.ref import BF16_MAX_MISMATCH
    b = max(r["bound"])
    extra = ""
    if "mismatch" in r:
        extra = (f", {r['mismatch']!r} of elements differ (tol "
                 f"{BF16_MAX_MISMATCH})")
    if "grouping" in r:
        extra = (f", sums and counts bitwise equal: {r['exact']}, rows per "
                 f"distinct code in a 32-row step {r['grouping']!r}")
    if "bitwise" in r:
        extra += f", two launches bitwise equal: {r['bitwise']}"
    if "unfused_ms" in r:
        extra += (f", unfused_ms={r['unfused_ms']!r} kernel_ms="
                  f"{r['kernel_ms']!r} fill_ms={r['fill_ms']!r} host_pack_ms="
                  f"{r['host_pack_ms']!r} h2d_ms={r['h2d_ms']!r}")
    stages = ", ".join(f"{n} {a!r}-{b!r} us"
                       for n, a, b in r["cuda_per_call"])
    n_kernels = sum(not n.startswith("Memcpy")
                    for n, _, _ in r["cuda_per_call"])
    print(f"[kernel] {name}: {r['shape']}: max_abs_err={r['max_abs_err']!r}"
          f" (tol {r['tol']!r}){extra}; CUDA kernels per call "
          f"{n_kernels} ({stages}; profiler, cold L2); "
          f"ms={r['ms']!r} "
          f"plain_ms={r['plain_ms']!r}"
          f" library_ms={r['library_ms']!r} bound_ms={b * 1e3!r} "
          f"({'bytes' if r['bound'][0] >= r['bound'][1] else 'operations'})")


def pq_random_inputs(np, torch):
    """Random keys of one layer's encode, (m, 131 072, dsub), and a random
    codebook, on the card."""
    rng = np.random.RandomState(PQ_RANDOM_SEED)
    x = torch.from_numpy(rng.randn(PQ_M, 131072, PQ_DSUB).astype(
        np.float32)).cuda()
    cb = torch.from_numpy(rng.randn(PQ_M, PQ_K, PQ_DSUB).astype(
        np.float32)).cuda()
    return x, cb


def _pq_kernel_rows(np, torch, flush):
    """B4 at the encode of one layer (m 16, N 131 072 = 64 chunks x 64 rows
    x 32 kv heads, dsub 8, K 256) and B5 at the largest training batch
    (N 114 688 = 3584 prompt tokens x 32 kv heads)."""
    from repro_torch.kernels.pq import ops as pq
    from repro_torch.kernels.pq.ref import centroid_norms

    rows = {}
    x, cb = pq_random_inputs(np, torch)
    c_k, cand = pq.pq_assign_candidates(x, cb)
    c_r = pq.pq_assign(x, cb, impl="ref")
    cbt = cb.transpose(1, 2)

    def library_assign():
        d = torch.baddbmm(centroid_norms(cb)[:, None, :], x, cbt, alpha=-2.0)
        return d.argmin(-1)

    flops = 2 * x.shape[0] * x.shape[1] * PQ_K * PQ_DSUB
    rows["pq_assign"] = dict(
        max_abs_err=float((c_k - c_r).abs().max().item()), tol=0.0,
        exact=bool(torch.equal(c_k, c_r)),
        ms=_time_ms(lambda: pq.pq_assign(x, cb), flush),
        plain_ms=_time_ms(lambda: pq.pq_assign(x, cb, impl="ref"), flush),
        library_ms=_time_ms(library_assign, flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: pq.pq_assign(x, cb), flush),
        # the products run on the TF32 tensor cores; the bound at the f32
        # rate of a scalar kernel is printed beside it
        bound=(_nbytes(x, cb, c_r) / HBM_BYTES_S, flops / PEAK_TF32),
        shape=f"x {tuple(x.shape)} f32, codebook {tuple(cb.shape)} f32")
    print(f"[kernel] pq_assign: mean candidates per row {cand!r} (random "
          f"keys); bound at the f32 rate {flops / PEAK_F32 * 1e3!r} ms")

    x = x[:, :114688].contiguous()
    rows["pq_update"] = b5_row(torch, x, pq.pq_assign(x, cb), flush)
    return rows


def b5_row(torch, x, codes, flush):
    """B5 against its plain version (bitwise, and over two launches), its
    time, the library call's and the bound; ``grouping`` is the mean
    number of rows per distinct code in a 32-row step (1 when all differ,
    32 when all share one), the skew B5's routing sees."""
    from repro_torch.kernels.pq import ops as pq
    dev = x.device
    m, N, dsub = x.shape
    s_k, n_k = pq.pq_update(x, codes, PQ_K)
    s_k2, n_k2 = pq.pq_update(x, codes, PQ_K)
    s_r, n_r = pq.pq_update(x, codes, PQ_K, impl="ref")
    flat = (codes.long() + PQ_K * torch.arange(m, device=dev)[:, None]
            ).reshape(-1)
    xf = x.reshape(-1, dsub)

    def library_update():
        sums = torch.zeros(m * PQ_K, dsub, device=dev).index_add_(0, flat, xf)
        return sums, torch.bincount(flat, minlength=m * PQ_K)

    steps = codes[:, :N // 32 * 32].reshape(-1, 32).sort(-1).values
    distinct = 1 + (steps[:, 1:] != steps[:, :-1]).sum(-1)
    return dict(
        max_abs_err=float((s_k - s_r).abs().max().item()), tol=0.0,
        exact=bool(torch.equal(s_k, s_r) and torch.equal(n_k, n_r)),
        bitwise=bool(torch.equal(s_k, s_k2) and torch.equal(n_k, n_k2)),
        ms=_time_ms(lambda: pq.pq_update(x, codes, PQ_K), flush),
        plain_ms=_time_ms(lambda: pq.pq_update(x, codes, PQ_K, impl="ref"),
                          flush, iters=5, warmup=1),
        library_ms=_time_ms(library_update, flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: pq.pq_update(x, codes, PQ_K), flush),
        grouping=float((32.0 / distinct.float()).mean().item()),
        bound=(_nbytes(x, codes, s_r, n_r) / HBM_BYTES_S,
               x.numel() / PEAK_F32),
        shape=f"x {tuple(x.shape)} f32, codes int32, K={PQ_K}")


def clustered_update_inputs(np, torch):
    """B5's inputs at the first Lloyd iteration of phase 3b: that phase's
    clustered training keys as (m, N, dsub) rows, coded by B4 against
    pq_train's strided-row initial codebook."""
    from repro_torch.kernels.pq import ops as pq
    keys = _clustered_keys(np, np.random.RandomState(PQ_KEYS_SEED), MAX_LEN,
                           32, 128)
    x = pq._subspaces(keys[:PROMPTS[-1]].reshape(-1, 128), PQ_M,
                      torch.device("cuda"))
    n = x.shape[1]
    idx = torch.from_numpy((np.arange(PQ_K) * max(1, n // PQ_K)) % n)
    return x, pq.pq_assign(x, x[:, idx.to(x.device)].contiguous())


def _clustered_keys(np, rng, S, Hkv, hd, n_clusters=64, span=8,
                    noise=0.25):
    """Keys with cluster runs of ``span`` tokens per kv head (the
    reference's PQ test layout, at one layer's width)."""
    centers = rng.randn(n_clusters, hd).astype(np.float32) * 2.0
    assign = rng.randint(0, n_clusters, (S // span, Hkv))
    assign = np.repeat(assign[:, None, :], span, 1).reshape(S, Hkv)
    return centers[assign] + rng.randn(S, Hkv, hd).astype(np.float32) * noise


def phase_pq_train(np, torch):
    """pq_train + pq_encode through B4/B5 against the plain versions, on
    clustered keys of one layer: 114 688 training rows (3584 prompt tokens
    x 32 kv heads), 131 072 encoded rows (64 chunks x 64 x 32), 4 Lloyd
    iterations from an empty codebook.  B4 and B5 are bitwise, so the
    codebooks, counts and codes must be byte-identical."""
    from repro_torch.kernels.pq import ops as pq
    keys = _clustered_keys(np, np.random.RandomState(PQ_KEYS_SEED), MAX_LEN,
                           32, 128)                         # (4096, 32, 128)
    vecs = keys.reshape(-1, 128)
    train = keys[:PROMPTS[-1]].reshape(-1, 128)
    cb0 = np.zeros((PQ_M, PQ_K, PQ_DSUB), np.float32)
    cnt0 = np.zeros((PQ_M, PQ_K), np.float64)
    runs = {}
    for name, impl in (("kernel", None), ("kernel_again", None),
                       ("plain", "ref")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb, cnt = pq.pq_train(train, cb0, cnt0, iters=4, impl=impl,
                              device="cuda")
        codes = pq.pq_encode(vecs, cb, impl=impl, device="cuda")
        runs[name] = (cb, cnt, codes, time.perf_counter() - t0)
    cb_k, cnt_k, codes_k, t_k = runs["kernel"]
    cb_r, cnt_r, codes_r, t_r = runs["plain"]
    _, cand = pq.pq_assign_candidates(
        pq._subspaces(vecs, PQ_M, torch.device("cuda")),
        torch.from_numpy(cb_k).cuda())
    same = all(a.tobytes() == b.tobytes()
               for a, b in zip(runs["kernel"][:3], runs["kernel_again"][:3]))
    equal = {k: a.tobytes() == b.tobytes() for k, a, b in
             zip(("codebook", "counts", "codes"), runs["kernel"][:3],
                 runs["plain"][:3])}
    cb_rel = float(np.abs(cb_k - cb_r).max() / np.abs(cb_r).max())
    differ = float((codes_k != codes_r).mean())
    print(f"[pq_train] {train.shape[0]} training rows, {vecs.shape[0]} "
          f"encoded, m={PQ_M} K={PQ_K} dsub={PQ_DSUB}, 4 Lloyd iterations: "
          f"kernels vs plain byte-identical {equal} (codebook max|diff|/"
          f"max|cb| {cb_rel!r}, codes that differ {differ!r}); two kernel "
          f"runs byte-identical: {same}; wall s kernel {t_k!r} plain "
          f"{t_r!r}; B4 mean candidates per row on these keys {cand!r}")
    if not (same and all(equal.values())):
        raise SystemExit("chip_smoke: pq_train through the kernels "
                         "disagrees with the plain versions")
    return {"byte_identical": equal, "cb_rel": cb_rel,
            "codes_differ": differ, "pq_assign_mean_candidates": cand}


def serve_prompts(np, cfg):
    """The serve's 4 prompts (after the warm-up prompt's draw)."""
    rng = np.random.RandomState(0)
    rng.randint(2, cfg.vocab_size, 64)
    return [rng.randint(2, cfg.vocab_size, n) for n in PROMPTS]


def _spy_admissions(eng, record):
    """Wrap ``eng._admit`` to record, per whole-prompt admission, the
    thread it ran on and its host-clock span."""
    import threading
    admit = eng._admit

    def spy(*a, **kw):
        t0 = time.perf_counter()
        try:
            return admit(*a, **kw)
        finally:
            record.append((threading.current_thread().name, t0,
                           time.perf_counter()))

    eng._admit = spy


def _spy_round_waits(eng, waits):
    """Count, on the decode thread, the seconds spent inside the store's
    locked calls of a round (abstract read, pooled fetch, append) and
    waiting for the prefetch worker's futures (which queue behind the
    write-behind ingest on the same worker); ``waits`` holds the running
    totals."""
    import threading
    main = threading.current_thread()
    store = eng.store

    def add(key, fn):
        def timed(*a, **kw):
            if threading.current_thread() is not main:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                waits[key] += time.perf_counter() - t0
        return timed

    for name in ("read_abstracts_batch", "read_abstracts_pq_batch",
                 "fetch_chunks_pooled", "append_tokens_batch"):
        setattr(store, name, add("store_s", getattr(store, name)))

    class Prefetch:
        def __init__(self, ex):
            self.ex = ex

        def submit(self, fn, *a, **kw):
            fut = self.ex.submit(fn, *a, **kw)
            fut.result = add("prefetch_wait_s", fut.result)
            return fut

    eng._executor = Prefetch(eng._executor)


def phase_serve(np, torch, cfg, params, pq: bool = False,
                mode: str = "sync", sidecar: bool = False):
    """A main path: 4 requests through the batcher, counters checked.
    ``pq`` turns on the PQ abstract plane (phase 4b): B4 and B5 train and
    encode at ingest, evaluation scores code-valid chunks by ADC.
    ``mode`` is the admission (phase 4d): ``"async"`` is
    ``SchedulerCfg(overlap_admission=True)``, ``"chunked"``
    ``chunked_admission=True`` with ``CHUNKED_ROUND_TOKENS`` prompt tokens
    between two rounds.  ``sidecar`` turns on the packed int4 disk
    sidecar (phase 4e) and gates its billing."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.pq import ops as pqk
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                               SchedulerCfg)

    tag = "[serve-pq]" if pq else "[serve-sidecar]" if sidecar else (
        "[serve]" if mode == "sync" else f"[serve-{mode}]")
    ecfg = EngineCfg(max_len=MAX_LEN, real_codec=True, pooled=True,
                     pipeline=True, pq_abstracts=pq, disk_sidecar=sidecar)
    root = KV_ROOT / tag.strip("[]")
    eng = BatchedLeoAMEngine(cfg, params, ecfg, max_seqs=len(PROMPTS),
                             device="cuda", store_root=str(root))
    warm = not pq and mode == "sync" and not sidecar
    if warm:
        # warm-up (cuBLAS handles, allocator): one short prefill, released.
        # No decode round: it would seed the measured-cost θ balance, which
        # the main path must start from, as a fresh server does.  The PQ
        # and mode serves run after this one in the same process and skip
        # it (the PQ serve's first request must find an untrained codebook)
        rng = np.random.RandomState(0)
        sid, _ = eng.add_sequence(rng.randint(2, cfg.vocab_size, 64))
        eng.release(sid)
    prompts = serve_prompts(np, cfg)
    batcher = ContinuousBatcher(engine=eng, cfg=SchedulerCfg(
        max_active=4, chunk=64, overlap_admission=mode == "async",
        chunked_admission=mode == "chunked",
        prefill_round_tokens=CHUNKED_ROUND_TOKENS))
    admits, rounds_t = [], []
    waits = {"store_s": 0.0, "prefetch_wait_s": 0.0}
    _spy_admissions(eng, admits)
    _spy_round_waits(eng, waits)
    decode_round = eng.decode_round

    def timed_round(tokens):
        w0 = dict(waits)
        t0 = time.perf_counter()
        try:
            return decode_round(tokens)
        finally:
            rounds_t.append((t0, time.perf_counter(),
                             *(waits[k] - w0[k] for k in sorted(waits))))

    eng.decode_round = timed_round
    replica_reads = _spy_replica_reads(eng.store) if sidecar else None
    log0 = dict(eng.store.log.bytes)
    ops0 = dict(eng.store.log.ops)
    cb.launches = sd.launches = kq.launches = 0
    pqk.assign_launches = pqk.update_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=NEW_TOKENS))
    finished = batcher.run()
    eng.store.requant_fence()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chunk_bounds": cb.launches, "sparse_decode": sd.launches,
                "kv_dequant": kq.launches, "pq_assign": pqk.assign_launches,
                "pq_update": pqk.update_launches}
    st = batcher.stats()
    rounds = len(eng.round_profiles)
    n_attn = len(eng.attn_layers)
    stages = ("eval_s", "gather_s", "upload_s", "attend_s", "total_s")
    prof = {k: float(np.mean([p[k] for p in eng.round_profiles]))
            for k in stages}
    med = {k: float(np.median([p[k] for p in eng.round_profiles]))
           for k in stages}
    first = {k: eng.round_profiles[0][k] for k in stages}
    tiers, kinds = {}, {}
    for (src, dst, kind), v in eng.store.log.bytes.items():
        moved = v - log0.get((src, dst, kind), 0.0)
        tiers[f"{src}->{dst}"] = tiers.get(f"{src}->{dst}", 0.0) + moved
        kinds[kind] = kinds.get(kind, 0.0) + moved

    def billed(src, dst, kind):
        key = (src, dst, kind)
        log = eng.store.log
        return {"bytes": log.bytes.get(key, 0.0) - log0.get(key, 0.0),
                "ops": log.ops.get(key, 0) - ops0.get(key, 0)}

    disk_kv = billed("disk", "host", "kv")
    print(f"{tag} {len(finished)} requests, {rounds} decode rounds, "
          f"wall {wall!r} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")
    print(f"{tag} TTFT mean {st.get('mean_ttft_s')!r} s p95 "
          f"{st.get('p95_ttft_s')!r} s; decode tok/s per request mean "
          f"{st.get('mean_decode_tok_s')!r}; throughput "
          f"{st.get('throughput_tok_s')!r} tok/s")
    for name, d in (("mean", prof), ("median", med), ("first", first)):
        print(f"{tag} round breakdown ({name} s/round): "
              + " ".join(f"{k}={v!r}" for k, v in d.items()))
    for i, a in enumerate(eng.admit_profiles[1 if warm else 0:]):
        print(f"{tag} admission {i}: " + " ".join(
            f"{k}={v!r}" for k, v in a.items()))
    # decode rounds that overlapped an admission (on the worker, or a
    # chunk step between rounds) against those that did not
    # (rounds_t rows: start, end, prefetch wait s, store calls s)
    spans = [(a, b) for _, a, b in admits]
    over = [any(r[0] < s1 and s0 < r[1] for s0, s1 in spans)
            for r in rounds_t]

    def median_of(rows, i):
        return float(np.median([r[i] for r in rows])) if rows else None

    gaps = [b[0] - a[1] for a, b in zip(rounds_t, rounds_t[1:])]
    contention = {}
    for name, rows in (("during_admission",
                        [(r[1] - r[0], *r[2:]) for r, o in zip(rounds_t, over)
                         if o]),
                       ("without_admission",
                        [(r[1] - r[0], *r[2:]) for r, o in zip(rounds_t, over)
                         if not o])):
        contention[f"rounds_{name}"] = len(rows)
        contention[f"median_round_{name}_s"] = median_of(rows, 0)
        contention[f"median_prefetch_wait_{name}_s"] = median_of(rows, 1)
        contention[f"median_store_calls_{name}_s"] = median_of(rows, 2)
    walls = [r[1] - r[0] for r in rounds_t]
    contention.update({
        # decode_round's wall, its ingest fence included (the round
        # profiles start after the fence)
        "first_round_wall_s": walls[0] if walls else None,
        "max_round_wall_s": max(walls) if walls else None,
        "max_gap_between_rounds_s": max(gaps) if gaps else None,
        "admission_threads": sorted({n for n, _, _ in admits}),
        "chunk_step_ewma_s": st.get("chunk_step_ewma_s")})
    print(f"{tag} rounds and admissions: {json.dumps(contention)}")
    print(f"{tag} tier bytes: {json.dumps(tiers, sort_keys=True)}")
    print(f"{tag} bytes by kind: {json.dumps(kinds, sort_keys=True)}")
    print(f"{tag} launches: {json.dumps(launches)} (per round: "
          + " ".join(f"{k}={v / max(rounds, 1)!r}" for k, v in launches.items())
          + f"; attention layers {n_attn}); codec uploads "
          f"{eng.store.codec_uploads} plain uploads {eng.store.plain_uploads}")
    faults = eng.fault_stats()
    if pq:
        print(f"{tag} pq_fallbacks {faults['pq_fallbacks']!r} pq_reencodes "
              f"{faults['pq_reencodes']!r} checksum_failures "
              f"{faults['checksum_failures']!r}")
    errors = [r.error for r in finished if r.error]
    if errors or len(finished) != len(PROMPTS):
        raise SystemExit(f"chip_smoke: serve failed: {errors}")
    for r in finished:
        if len(r.out) != NEW_TOKENS or not all(
                0 <= t < cfg.vocab_size for t in r.out):
            raise SystemExit(f"chip_smoke: request {r.rid} gave {r.out}")
    path = list(launches) if pq else ["chunk_bounds", "sparse_decode",
                                      "kv_dequant"]
    zero = [k for k in path if launches[k] <= 0]
    if zero:
        raise SystemExit(f"chip_smoke: {tag} path never launched {zero}")
    if pq and (faults["pq_fallbacks"] != 0 or kinds.get("pq_codes_read",
                                                         0.0) <= 0):
        raise SystemExit(f"chip_smoke: {tag} PQ codes did not serve: "
                         f"{faults}")
    if mode == "async" and (len(admits) != len(PROMPTS) or not all(
            n.startswith("leoam-admit") for n, _, _ in admits)):
        raise SystemExit(f"chip_smoke: {tag} admissions did not all run on "
                         f"the admission worker: {admits}")
    if mode == "chunked" and (admits or "chunk_step_ewma_s" not in st
                              or not all(p.get("chunked") == 1.0
                                         for p in eng.admit_profiles)):
        raise SystemExit(f"chip_smoke: {tag} did not admit chunked: "
                         f"{admits} {eng.admit_profiles} {st}")
    if mode == "sync" and not all(n == "MainThread" for n, _, _ in admits):
        raise SystemExit(f"chip_smoke: {tag} admitted off the decode "
                         f"thread: {admits}")
    side = None
    if sidecar:
        side = sidecar_gate(eng.store, tag, disk_kv,
                            billed("host", "disk", "kv_replica"),
                            billed("disk", "host", "kv_fallback"),
                            replica_reads)
    eng.store.close()
    del eng, decode_round, timed_round
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "round_s": prof, "round_median_s": med,
            "disk_kv": disk_kv, "sidecar": side,
            "ttft_mean_s": st.get("mean_ttft_s"),
            "ttft_p95_s": st.get("p95_ttft_s"),
            "decode_tok_s_mean": st.get("mean_decode_tok_s"),
            "throughput_tok_s": st.get("throughput_tok_s"),
            "contention": contention,
            "pq_fallbacks": faults["pq_fallbacks"],
            "pq_reencodes": faults["pq_reencodes"]}


def _spy_replica_reads(store):
    """Record every chunk the store reads off its fp16 replica, with its
    sidecar's valid bit at the time of the read: [(row, layer, chunk,
    valid), ...]."""
    reads = []
    read = store._replica_read_verified

    def spy(layer, entries):
        reads.extend((p, layer, c, bool(store._sidecar_valid[p, layer, c]))
                     for _, p, c in entries)
        return read(layer, entries)

    store._replica_read_verified = spy
    return reads


def sidecar_gate(store, tag, disk_kv, replica, fallback, replica_reads):
    """Phase 4e's gate.  Every ``kv_replica`` write, and every disk->host
    ``kv`` read served by the sidecar, is billed exactly ``chunk_bytes *
    codec_ratio("int4", 64)``.  The reference reads a chunk whose sidecar
    a decode append invalidated off the fp16 replica and bills it at fp16
    under the same kind, so those reads (counted by the spy, each of a
    chunk whose sidecar was invalid) are taken out first; no read may fall
    back on a failed CRC."""
    from repro_torch.core.compression import codec_ratio
    full = float(store.chunk_bytes)
    packed = full * codec_ratio("int4", 64)
    n_fp16 = len(replica_reads)
    n_packed = disk_kv["ops"] - n_fp16
    res = {"chunk_bytes": full, "packed_bytes": packed,
           "kv_replica": replica,
           "kv_replica_bytes_per_op":
           replica["bytes"] / max(1, replica["ops"]),
           "sidecar_reads": n_packed,
           "sidecar_bytes_per_read": (disk_kv["bytes"] - n_fp16 * full)
           / max(1, n_packed),
           "fp16_reads_of_appended_chunks": n_fp16,
           "fp16_reads_with_a_valid_sidecar":
           sum(v for *_, v in replica_reads),
           "kv_fallback": fallback, "sidecar_repacks": store.sidecar_repacks,
           "degraded_seqs": len(store.degraded_seqs)}
    print(f"{tag} sidecar billing: {json.dumps(res)}")
    fails = []
    if replica["ops"] <= 0 or replica["bytes"] != replica["ops"] * packed:
        fails.append("kv_replica not billed at the packed bytes")
    if n_packed <= 0 or disk_kv["bytes"] - n_fp16 * full != n_packed * packed:
        fails.append("sidecar reads not billed at the packed bytes")
    if res["fp16_reads_with_a_valid_sidecar"] or fallback["ops"]:
        fails.append("an fp16 read of a chunk whose sidecar could serve it")
    if fails:
        raise SystemExit(f"chip_smoke: {tag} " + "; ".join(fails))
    return res


def phase_legacy(np, torch, cfg, params):
    """Phase 4f: the serve's shortest and longest prompts, driven through
    the engine with ``pooled=False`` (the working set assembled on the host
    and uploaded whole every round; B2 reads it in place) and with
    ``pooled=True``, both ``real_codec=False, pipeline=False``.  The two
    must give identical token streams."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompts = serve_prompts(np, cfg)
    prompts = [prompts[0], prompts[-1]]
    res = {}
    for pooled in (False, True):
        name = "pooled" if pooled else "legacy"
        root = KV_ROOT / f"serve-{name}"
        eng = BatchedLeoAMEngine(
            cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=False,
                                   pipeline=False, pooled=pooled),
            max_seqs=len(prompts), device="cuda", store_root=str(root))
        upload = [0]
        if not pooled:
            fetch = eng.store.fetch_chunks_batch

            def counted(*a, _fetch=fetch, **kw):
                kg, vg, nsel = _fetch(*a, **kw)
                upload[0] += kg.nbytes + vg.nbytes
                return kg, vg, nsel

            eng.store.fetch_chunks_batch = counted
        cb.launches = sd.launches = kq.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, streams = {}, {}
        for p in prompts:
            sid, tok = eng.add_sequence(p)
            toks[sid], streams[sid] = tok, [tok]
        logits = [np.stack([eng.seqs[s].prefill_logits for s in sorted(toks)])]
        for _ in range(LEGACY_NEW_TOKENS - 1):
            toks = eng.decode_round(toks)
            logits.append(eng.last_logits.copy())
            for sid, tok in toks.items():
                streams[sid].append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = len(eng.round_profiles)
        res[name] = {
            "streams": [streams[s] for s in sorted(streams)],
            "logits": logits, "wall_s": wall, "rounds": rounds,
            "round_median_s": float(np.median(
                [p["total_s"] for p in eng.round_profiles])),
            "round_first_s": eng.round_profiles[0]["total_s"],
            "upload_bytes_per_round": upload[0] / max(1, rounds),
            "launches": {"chunk_bounds": cb.launches,
                         "sparse_decode": sd.launches,
                         "kv_dequant": kq.launches},
            "h2d_kv_bytes_per_round": eng.store.log.bytes.get(
                ("host", "device", "kv"), 0.0) / max(1, rounds)}
        eng.store.close()
        del eng
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    leg, poo = res["legacy"], res["pooled"]
    same = leg["streams"] == poo["streams"]
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(leg["logits"], poo["logits"]))
    row = {"prompts": [len(p) for p in prompts],
           "new_tokens": LEGACY_NEW_TOKENS, "streams_identical": same,
           "max_logit_diff": diff,
           **{f"{n}_{k}": r[k] for n, r in res.items()
              for k in ("round_median_s", "round_first_s", "wall_s",
                        "upload_bytes_per_round", "h2d_kv_bytes_per_round",
                        "launches")}}
    print(f"[serve-legacy] {json.dumps(row)}")
    bad = []
    if not same:
        bad.append(f"token streams differ: {leg['streams']} vs "
                   f"{poo['streams']}")
    if leg["launches"]["chunk_bounds"] <= 0 or \
            leg["launches"]["sparse_decode"] <= 0:
        bad.append(f"the legacy serve did not launch B1 and B2: "
                   f"{leg['launches']}")
    if bad:
        raise SystemExit("chip_smoke: [serve-legacy] " + "; ".join(bad))
    return row


def phase_reopen(np, torch):
    """Phase 4g: a reopened store on the card against the same script on
    a CPU store with the plain versions.  One sequence of the longest
    prompt over two longchat-shaped layers (64 chunks of 64 x 32 x 128),
    ingested write-behind with the sidecar and the real codec under the
    engine's placement, fenced, flushed and closed; reopened, every chunk
    promoted into the pool (θ 0.5: half of each upload through B3)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving.offload import DEVICE, DISK, HOST, TieredKVStore
    L, NC, C, HKV, HD = 2, MAX_LEN // 64, 64, 32, 128
    kw = dict(n_seqs=1, transit_codec="int4", use_pool=True,
              real_codec=True, disk_sidecar=True)
    rng = np.random.RandomState(7)
    S = PROMPTS[-1]
    kv = []
    for _ in range(L):
        k = np.zeros((NC * C, HKV, HD), np.float16)
        v = np.zeros_like(k)
        k[:S] = rng.randn(S, HKV, HD)
        v[:S] = rng.randn(S, HKV, HD)
        kv.append((k, v))
    place = {c: DEVICE if c < 9 else (HOST if c < 37 else DISK)
             for c in range(NC)}
    out = {}
    t0 = time.perf_counter()
    for dev, impl in (("cuda", None), ("cpu", "ref")):
        root = str(KV_ROOT / f"reopen_{dev}")
        st = TieredKVStore(L, NC, C, HKV, HD, root=root, device=dev,
                           impl=impl, **kw)
        with ThreadPoolExecutor(1) as ex:
            for layer, (k, v) in enumerate(kv):
                st.ingest(layer, k, v, place, seq=0, executor=ex)
            st.ingest_fence(0)
        for m in (st._disk, st._disk_q, st._disk_scale, st._crc,
                  st._crc_state, st._q_crc):
            m.flush()
        st.close()
        st = TieredKVStore(L, NC, C, HKV, HD, root=root, device=dev,
                           impl=impl, reopen=True, **kw)
        res = []
        for layer in range(L):
            slots, _, fs = st.fetch_chunks_pooled(layer,
                                                  {0: list(range(NC))},
                                                  theta=0.5)
            res.append((slots.tolist(), fs.disk_reads, fs.compressed,
                        fs.disk_bytes, fs.upload_bytes))
        torch.cuda.synchronize()
        out[dev] = (res, [p.kv.cpu() for p in st.pools], dict(st.log.bytes))
        st.close()
        shutil.rmtree(root, ignore_errors=True)
    bitwise = all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                    out["cpu"][1]))
    row = {"layers": L, "chunks": NC, "tokens": S,
           "disk_reads_per_layer": out["cuda"][0][0][1],
           "compressed_per_layer": out["cuda"][0][0][2],
           "slots_equal": out["cuda"][0] == out["cpu"][0],
           "pool_bitwise": bitwise,
           "logs_equal": out["cuda"][2] == out["cpu"][2],
           "wall_s": time.perf_counter() - t0}
    print(f"[reopen] {json.dumps(row)}")
    if not (row["slots_equal"] and bitwise and row["logs_equal"]
            and row["disk_reads_per_layer"] == NC):
        raise SystemExit("chip_smoke: [reopen] the reopened card store "
                         "differs from the CPU store")
    return row


def phase_admission(np, torch, cfg, params):
    """Phase 4c: two of the serve's prompts, each admitted on three fresh
    engines (sync, async, chunked), every store fenced, then held against
    the synchronous admission."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompts = serve_prompts(np, cfg)
    out = []
    for p in (prompts[0], prompts[-1]):
        S = len(p)
        res = {}
        for mode in ("sync", "async", "chunked"):
            root = KV_ROOT / f"admit_{S}_{mode}"
            eng = BatchedLeoAMEngine(
                cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=True,
                                       pipeline=True),
                device="cuda", store_root=str(root))
            admits = []
            _spy_admissions(eng, admits)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "sync":
                sid, tok = eng.add_sequence(p)
                steps = None
            elif mode == "async":
                sid, tok = eng.add_sequence_async(p).result()
                steps = None
            else:
                adm = eng.begin_admission(p)
                sid, tok = adm.drain()
                steps = adm.n_steps
            eng.store.ingest_fence(sid)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.store
            res[mode] = dict(
                tok=tok, logits=eng.seqs[sid].prefill_logits.copy(),
                km=st._abs_km[sid].copy(), kn=st._abs_kn[sid].copy(),
                disk=(os.path.join(st._root, "kv.bin"), st._disk.shape, sid),
                threads=[n for n, _, _ in admits], steps=steps, wall=wall,
                profile=dict(eng.admit_profiles[-1]),
                C=eng.ecfg.prefill_chunk_tokens)
            st.close()
            del eng, st
            gc.collect()
            torch.cuda.empty_cache()
        sync, ov, ch = res["sync"], res["async"], res["chunked"]

        def replica(r):
            path, shape, sid = r["disk"]
            return np.memmap(path, dtype=np.float16, mode="r",
                             shape=shape)[sid]

        rs, ro, rc = replica(sync), replica(ov), replica(ch)
        ov_equal = all(np.array_equal(rs[li], ro[li])
                       for li in range(rs.shape[0]))
        ch_diff = max(float(np.abs(rs[li].astype(np.float32)
                                   - rc[li].astype(np.float32)).max())
                      for li in range(rs.shape[0]))
        ch_frac = float(np.mean([(rs[li] != rc[li]).mean()
                                 for li in range(rs.shape[0])]))
        del rs, ro, rc
        abs_equal = (np.array_equal(sync["km"], ov["km"])
                     and np.array_equal(sync["kn"], ov["kn"]))
        fin = np.isfinite(sync["km"])
        ch_abs = float(max(np.abs(sync["km"] - ch["km"])[fin].max(),
                           np.abs(sync["kn"] - ch["kn"])[fin].max()))
        bar = TOL_E2E_ULPS * _bf16_ulp(float(np.abs(sync["logits"]).max()))
        ch_logit = float(np.abs(ch["logits"] - sync["logits"]).max())
        ov_logit = float(np.abs(ov["logits"] - sync["logits"]).max())
        want_steps = -(-S // ch["C"])
        row = {"prompt": S, "first_token": {m: r["tok"] for m, r in
                                            res.items()},
               "overlap_replica_bitwise": ov_equal,
               "overlap_abstracts_bitwise": abs_equal,
               "overlap_max_logit_diff": ov_logit,
               "chunked_max_logit_diff": ch_logit, "logit_tol": bar,
               "chunked_max_replica_diff": ch_diff,
               "chunked_replica_fraction_differ": ch_frac,
               "chunked_max_abstract_diff": ch_abs,
               "async_threads": ov["threads"], "chunked_steps": ch["steps"],
               "chunked_steps_expected": want_steps,
               "admit_wall_s": {m: r["wall"] for m, r in res.items()},
               "admit_profile": {m: r["profile"] for m, r in res.items()}}
        print(f"[admit] {json.dumps(row)}")
        for m in res:
            shutil.rmtree(KV_ROOT / f"admit_{S}_{m}", ignore_errors=True)
        fails = []
        if not (ov_equal and abs_equal and ov["tok"] == sync["tok"]):
            fails.append("overlapped admission differs from synchronous")
        if ch_logit > bar:
            fails.append("chunked first-token logits beyond the bar")
        if not (len(ov["threads"]) == 1
                and ov["threads"][0].startswith("leoam-admit")):
            fails.append(f"async admission ran on {ov['threads']}")
        if sync["threads"] != ["MainThread"] or ch["threads"]:
            fails.append(f"sync/chunked admission threads "
                         f"{sync['threads']} {ch['threads']}")
        if ch["steps"] != want_steps:
            fails.append(f"chunked admission took {ch['steps']} steps")
        if fails:
            raise SystemExit(f"chip_smoke: admission parity at S={S}: "
                             + "; ".join(fails))
        out.append(row)
    return out


def _launch_counts():
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    return {"chunk_bounds": cb.launches, "sparse_decode": sd.launches,
            "kv_dequant": kq.launches}


def _zero_launches():
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    cb.launches = sd.launches = kq.launches = 0


def _engine_leaks(eng):
    """What a released engine may not hold any more (the reference's
    ``_assert_engine_clean``): [] when clean."""
    st = eng.store
    leaks = []
    if sorted(eng._free) != list(range(eng.max_seqs)):
        leaks.append(f"free slots {sorted(eng._free)}")
    if eng.seqs or eng.suspended:
        leaks.append(f"live {sorted(eng.seqs)} suspended "
                     f"{sorted(eng.suspended)}")
    if st._swapped:
        leaks.append(f"swap ledger {sorted(st._swapped)}")
    if any(st._ingest_futs.values()):
        leaks.append("ingest futures in flight")
    ps = st.pool_stats()
    if ps["free_slots"] != ps["slots"]:
        leaks.append(f"pool {ps}")
    return leaks


def _spy_recovery(eng):
    """Record 4h's recovery on ``eng`` and return the record: every
    ``_flip_bit`` of a replica (the chunk's bytes before the flip), every
    ``restore_chunk`` (its key and the restored replica bytes), the wall
    time of each ``_recover_lost`` (the prefill replay and the restores)
    and each attempt of a round's body (``_decode_round_impl``: seconds,
    and whether it returned)."""
    import numpy as np
    st = eng.store
    rec = {"flipped": {}, "restored": {}, "recover_s": [], "attempts": []}
    flip, restore = st._flip_bit, st.restore_chunk
    recover, attempt = eng._recover_lost, eng._decode_round_impl

    def flip_spy(site, key):
        if site == "disk_read" and key:
            p, layer, c = key[0]
            rec["flipped"][(int(layer), int(p), int(c))] = np.array(
                st._disk[p, layer, c])
        return flip(site, key)

    def restore_spy(layer, seq, c, k_rows, v_rows):
        restore(layer, seq, c, k_rows, v_rows)
        rec["restored"][(layer, seq, c)] = np.array(st._disk[seq, layer, c])

    def recover_spy(e, live):
        t0 = time.perf_counter()
        try:
            return recover(e, live)
        finally:
            rec["recover_s"].append(time.perf_counter() - t0)

    def attempt_spy(live):
        t0 = time.perf_counter()
        ok = False
        try:
            out = attempt(live)
            ok = True
            return out
        finally:
            rec["attempts"].append((time.perf_counter() - t0, ok))

    st._flip_bit, st.restore_chunk = flip_spy, restore_spy
    eng._recover_lost, eng._decode_round_impl = recover_spy, attempt_spy
    return rec


def _fault_engine(cfg, params, root, plan=None, max_seqs=3):
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    # pipeline=False: no speculative staging on the worker, so each fault
    # site sees its calls in one order and the explicit events land on
    # the decode thread's reads
    return BatchedLeoAMEngine(
        cfg, params,
        EngineCfg(max_len=MAX_LEN, real_codec=True, pipeline=False,
                  disk_sidecar=True, cpu_chunk_frac=FAULT_CPU_FRAC,
                  fault_plan=plan),
        max_seqs=max_seqs, device="cuda", store_root=str(root))


def _decode_rounds(eng, toks, n, rounds_s):
    """``n`` decode rounds from ``toks``, each round's wall appended to
    ``rounds_s``; returns the streams (first token included)."""
    streams = {sid: [t] for sid, t in toks.items()}
    for _ in range(n):
        t0 = time.perf_counter()
        toks = eng.decode_round(toks)
        rounds_s.append(time.perf_counter() - t0)
        for sid, t in toks.items():
            streams[sid].append(t)
    return streams


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def phase_faults(np, torch, cfg, params):
    """Phase 4h: the fault domain at full width (see the module
    docstring).  The fault-free engine runs second, with one engine alive
    at a time; the restored chunks' bytes are kept from the faulty run."""
    from repro_torch.serving.faults import FaultPlan

    prompts = serve_prompts(np, cfg)
    prompts = [prompts[0], prompts[1]]
    short = np.random.RandomState(5).randint(2, cfg.vocab_size,
                                             FAULT_SHORT_PROMPT)
    # read sites: the first disk->host gathers are the sidecar's (every
    # prompt chunk has a valid sidecar); a sidecar bitflip quarantines the
    # gather's first chunk (sequence 0's lowest selected disk chunk, a
    # prompt chunk: the two recent chunks are always selected) and its
    # fp16 fallback is the next replica read
    plan = FaultPlan(schedule={
        "sidecar_read": {2: "bitflip", 5: "bitflip"},
        "disk_read": {0: "io_error", 2: "bitflip"},
        "worker": {}})
    rec = None
    res = {}
    for faulty in (True, False):
        name = "faulty" if faulty else "clean"
        root = KV_ROOT / f"faults_{name}"
        eng = _fault_engine(cfg, params, root, plan if faulty else None)
        if faulty:
            rec = _spy_recovery(eng)
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = {}
        for p in prompts:
            sid, tok = eng.begin_admission(p).drain()
            toks[sid] = tok
        for sid in toks:
            eng.store.ingest_fence(sid)
        failing = None
        if faulty:
            # the short admission's sixth layer write raises on the worker
            plan.schedule["worker"][plan.calls()["worker"] + 5] = "exception"
            failing, tok = eng.begin_admission(short).drain()
            toks[failing] = tok
        admit_s = time.perf_counter() - t0
        rounds_s = []
        streams = _decode_rounds(eng, toks, FAULT_NEW_TOKENS - 1, rounds_s)
        torch.cuda.synchronize()
        launches = _launch_counts()
        fs = eng.fault_stats()
        failed = dict(eng.failed)
        degraded = sorted(eng.store.degraded_seqs)
        # the restored chunks' rows on this engine, before release (the
        # fault-free run compares its own replica to the faulty one's)
        mine = {key: np.array(eng.store._disk[key[1], key[0], key[2]])
                for key in rec["restored"]}
        for sid in list(streams):
            if sid in eng.seqs:
                eng.release(sid)
        leaks = _engine_leaks(eng)
        res[name] = dict(streams=streams, launches=launches, faults=fs,
                         failed=failed, failing=failing, leaks=leaks,
                         rows=mine, admit_s=admit_s, rounds_s=rounds_s,
                         degraded=degraded)
        eng.store.close()
        del eng
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    f, c = res["faulty"], res["clean"]
    restored_equal = all(np.array_equal(rows, c["rows"][key])
                         for key, rows in rec["restored"].items())
    flipped_back = {key: np.array_equal(rec["flipped"][key], rows)
                    for key, rows in rec["restored"].items()
                    if key in rec["flipped"]}
    # the recovering round: the body's attempt that raised, the recovery
    # (selection rollback, prefill replay, restores) and the attempt that
    # then succeeded
    att = rec["attempts"]
    failed_at = [i for i, (_, ok) in enumerate(att) if not ok]
    recovery = {
        "failed_attempt_s": [att[i][0] for i in failed_at],
        "recover_s": rec["recover_s"],
        "retry_attempt_s": [att[i + 1][0] for i in failed_at
                            if i + 1 < len(att)],
        "median_attempt_s": float(np.median([t for t, ok in att if ok]))}
    recovery["total_s"] = (sum(recovery["failed_attempt_s"])
                           + sum(recovery["recover_s"])
                           + sum(recovery["retry_attempt_s"]))
    sync = _sync_recovery(np, torch, cfg, params, prompts[0])
    fails = []
    if set(f["streams"]) != {0, 1, 2} or any(
            len(f["streams"][s]) != FAULT_NEW_TOKENS for s in (0, 1)):
        fails.append(f"streams {f['streams']}")
    if list(f["failed"]) != [f["failing"]]:
        fails.append(f"failed {f['failed']} (want only {f['failing']})")
    fsf = f["faults"]
    if not (fsf["io_retries"] >= 1 and fsf["checksum_failures"] >= 2
            and fsf["chunks_recomputed"] >= 1):
        fails.append(f"fault counters {fsf}")
    if not rec["restored"] or not restored_equal:
        fails.append("restored replica rows differ from the fault-free "
                     "engine's")
    for name in ("faulty", "clean"):
        if res[name]["leaks"]:
            fails.append(f"{name} engine leaked {res[name]['leaks']}")
    zero = [k for k, v in f["launches"].items() if v <= 0]
    if zero:
        fails.append(f"never launched {zero}")
    row = {
        "prompts": [len(p) for p in prompts],
        "short_prompt": FAULT_SHORT_PROMPT, "new_tokens": FAULT_NEW_TOKENS,
        "events": [(e.site, e.index, e.kind, list(e.key)
                    if isinstance(e.key, tuple) else e.key)
                   for e in plan.fired_events()],
        "faults": fsf, "failed": {str(k): v for k, v in f["failed"].items()},
        "degraded_seqs": f["degraded"],
        "restored_chunks": [list(k) for k in rec["restored"]],
        "restored_rows_bitwise_vs_fault_free": restored_equal,
        "restored_rows_bitwise_vs_before_the_flip": list(
            flipped_back.values()),
        "recovery": recovery,
        "first_round_s": {"faulty": f["rounds_s"][0],
                          "fault_free": c["rounds_s"][0]},
        "median_round_s": {"faulty": float(np.median(f["rounds_s"])),
                           "fault_free": float(np.median(c["rounds_s"]))},
        "admit_s": {"faulty": f["admit_s"], "fault_free": c["admit_s"]},
        "streams_equal_fault_free": {
            str(s): f["streams"][s] == c["streams"][s] for s in (0, 1)},
        "first_differing_token": {
            str(s): _first_diff(f["streams"][s], c["streams"][s])
            for s in (0, 1)},
        "launches": f["launches"], "sync_recovery": sync}
    print(f"[faults] {json.dumps(row)}")
    for s in (0, 1):
        print(f"[faults] seq {s} stream {f['streams'][s]} against fault-free "
              f"{c['streams'][s]}")
    if fails:
        raise SystemExit("chip_smoke: [faults] " + "; ".join(fails))
    return row


def _sync_recovery(np, torch, cfg, params, prompt):
    """4h's recovery once more for a synchronously admitted prompt: the
    first sidecar read's first chunk is quarantined and its fallback read
    flips a replica bit, so round 1 recomputes the chunk by chunked
    prefill; returns the restored rows' largest difference from the
    original (ROADMAP C8: chunked prefill's bf16 K/V differ from
    whole-prompt prefill's)."""
    from repro_torch.serving.faults import FaultPlan
    plan = FaultPlan(schedule={"sidecar_read": {0: "bitflip"},
                               "disk_read": {0: "bitflip"}})
    root = KV_ROOT / "faults_sync"
    eng = _fault_engine(cfg, params, root, plan, max_seqs=1)
    rec = _spy_recovery(eng)
    sid, tok = eng.add_sequence(prompt)
    t0 = time.perf_counter()
    eng.decode_round({sid: tok})
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    fs = eng.fault_stats()
    diffs, frac = [], []
    for key, rows in rec["restored"].items():
        orig = rec["flipped"].get(key)
        if orig is not None:
            d = np.abs(rows.astype(np.float32) - orig.astype(np.float32))
            # the flipped word itself: the original holds the pre-flip value
            diffs.append(float(d.max()))
            frac.append(float((rows != orig).mean()))
    eng.release(sid)
    leaks = _engine_leaks(eng)
    eng.store.close()
    del eng
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"prompt": len(prompt), "restored_chunks": [
        list(k) for k in rec["restored"]], "chunks_recomputed":
        fs["chunks_recomputed"], "recover_s": rec["recover_s"],
        "attempts_s": rec["attempts"],
        "round_with_recovery_s": round_s, "max_replica_diff": diffs,
        "fraction_differ": frac, "leaks": leaks}


def phase_preempt(np, torch, cfg, params):
    """Phase 4i: whole-sequence preemption at full width (see the module
    docstring)."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompts = serve_prompts(np, cfg)
    prompts = [prompts[0], prompts[1]]
    ecfg = EngineCfg(max_len=MAX_LEN, real_codec=False, pipeline=False)
    runs, batcher = {}, None
    for suspend in (True, False):
        name = "suspend" if suspend else "leave_out"
        root = KV_ROOT / f"preempt_{name}"
        eng = BatchedLeoAMEngine(cfg, params, ecfg, max_seqs=3,
                                 device="cuda", store_root=str(root))
        st = eng.store
        cur = {}
        for p in prompts:
            sid, tok = eng.add_sequence(p)
            cur[sid] = tok
        victim = max(cur)              # the 2048-token sequence
        streams = {sid: [tok] for sid, tok in cur.items()}
        logits = []

        def rounds(live, n):
            for _ in range(n):
                live = eng.decode_round(live)
                logits.append({sid: eng.last_logits[i].copy()
                               for i, sid in enumerate(sorted(live))})
                for sid, t in live.items():
                    streams[sid].append(t)
            return live

        cur = rounds(cur, PREEMPT_AFTER)
        info = {}
        if suspend:
            held = lambda: sum(k[0] == victim for p in st.pools
                               for k in p.slot_of)
            info["victim_slots_before"] = held()
            info["free_slots_before_suspend"] = st.pool_stats()["free_slots"]
            eng.suspend_sequence(victim)
            info["victim_slots_after"] = held()
            info["free_slots_after_suspend"] = st.pool_stats()["free_slots"]
        cur.update(rounds({s: t for s, t in cur.items() if s != victim},
                          PREEMPT_ROUNDS))
        if suspend:
            eng.resume_sequence(victim)
        _zero_launches()
        while True:
            live = {s: t for s, t in cur.items()
                    if len(streams[s]) < FAULT_NEW_TOKENS}
            if not live:
                break
            cur.update(rounds(live, 1))
        torch.cuda.synchronize()
        info["launches_after_resume"] = _launch_counts()
        log = st.log
        info.update(
            swapouts=st.seq_swapouts, swapins=st.seq_swapins,
            swapout_ops=log.ops.get(("host", "disk", "kv_swapout"), 0),
            swapout_bytes=log.bytes.get(("host", "disk", "kv_swapout"), 0.0),
            swapin_ops=log.ops.get(("disk", "host", "kv_swapin"), 0),
            swapin_bytes=log.bytes.get(("disk", "host", "kv_swapin"), 0.0),
            chunk_bytes=st.chunk_bytes)
        for sid in list(streams):
            eng.release(sid)
        info["leaks"] = _engine_leaks(eng)
        runs[name] = (streams, logits, info)
        if suspend:
            batcher = _preempting_batcher(torch, eng, prompts)
        st.close()
        del eng, st, rounds
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    (sa, la, ia), (sb, lb, ib) = runs["suspend"], runs["leave_out"]
    same = sa == sb
    bitwise = len(la) == len(lb) and all(
        a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(la, lb))
    diff = max((float(np.abs(a[k] - b[k]).max()) for a, b in zip(la, lb)
                for k in a if k in b), default=None)
    fails = []
    if not (same and bitwise):
        fails.append(f"suspend/resume differs from leaving the sequence out "
                     f"(streams equal {same}, max logit diff {diff!r})")
    if not (ia["victim_slots_before"] > 0 and ia["victim_slots_after"] == 0
            and ia["free_slots_after_suspend"]
            > ia["free_slots_before_suspend"]):
        fails.append("suspend did not free the sequence's pool slots")
    if ia["swapout_ops"] <= 0 or ia["swapout_bytes"] != 0.0:
        fails.append("kv_swapout not billed as zero-byte ops")
    if ia["swapin_ops"] <= 0 or \
            ia["swapin_bytes"] != ia["swapin_ops"] * ia["chunk_bytes"]:
        fails.append("kv_swapin not billed at the chunk bytes")
    if not ia["swapouts"] == ia["swapins"] == 1:
        fails.append(f"swap counts {ia['swapouts']} / {ia['swapins']}")
    after = ia["launches_after_resume"]
    if after["chunk_bounds"] <= 0 or after["sparse_decode"] <= 0:
        fails.append(f"B1/B2 not launched after the resume: {after}")
    for name, (_, _, info) in runs.items():
        if info["leaks"]:
            fails.append(f"{name} leaked {info['leaks']}")
    fails += batcher.pop("fails")
    row = {"prompts": [len(p) for p in prompts],
           "new_tokens": FAULT_NEW_TOKENS,
           "suspended_after_round": PREEMPT_AFTER,
           "rounds_left_out": PREEMPT_ROUNDS,
           "streams_identical": same, "logits_bitwise": bitwise,
           "max_logit_diff": diff, "suspend_run": ia,
           "leave_out_run": {k: ib[k] for k in ("launches_after_resume",
                                                "leaks")},
           "batcher": batcher}
    print(f"[preempt] {json.dumps(row)}")
    if fails:
        raise SystemExit("chip_smoke: [preempt] " + "; ".join(fails))
    return row


def _preempting_batcher(torch, eng, prompts):
    """4i's batcher: the 1536- and 2048-token requests, then a
    high-priority 1536-token request after the first round, with a
    pressure monitor whose queue watermark is 0 (any queued request is
    yellow): the batcher suspends a victim for it and resumes the victim
    once it is done."""
    from repro_torch.serving.overload import PressureMonitor, WatermarkCfg
    from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                               SchedulerCfg)
    mon = PressureMonitor(eng, WatermarkCfg(queue_yellow=0, queue_red=99))
    b = ContinuousBatcher(engine=eng, monitor=mon,
                          cfg=SchedulerCfg(max_active=2, chunk=64))
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=p, max_new=FAULT_NEW_TOKENS))
    n0 = len(eng.round_profiles)
    for _ in range(100):               # both admitted, one round decoded
        if len(eng.round_profiles) > n0 and len(b.active) == 2:
            break
        b.step()
    b.submit(Request(rid=2, prompt=prompts[0], max_new=FAULT_NEW_TOKENS,
                     priority=5))
    done = b.run()
    torch.cuda.synchronize()
    st = b.stats()
    fails = []
    if not (st["suspensions"] >= 1 and st["resumes"] >= 1):
        fails.append(f"batcher did not preempt and resume: {st}")
    by = {r.rid: r for r in done}
    if sorted(by) != [0, 1, 2] or any(
            r.error or len(r.out) != FAULT_NEW_TOKENS for r in done):
        fails.append("batcher requests "
                     f"{[(r.rid, r.error, len(r.out)) for r in done]}")
    leaks = _engine_leaks(eng)
    if leaks:
        fails.append(f"batcher leaked {leaks}")
    return {"wall_s": time.perf_counter() - t0,
            "suspensions": st["suspensions"], "resumes": st["resumes"],
            "finished": sorted(by), "vip_done_before_its_victim": bool(
                2 in by and all(by[2].t_done <= r.t_done for r in done
                                if r.suspended_s > 0)),
            "suspended_s": {str(r.rid): r.suspended_s for r in done},
            "leaks": leaks, "fails": fails}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def phase_e2e(np, torch, cfg, params):
    """First request's prefill + 2 decode rounds: kernels vs plain.  The
    plain run goes first and records each layer's chunk selection; the
    kernel run replays them (B1 still runs), so only the kernels'
    arithmetic differs and a near-tied chunk choice cannot flip."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, PROMPTS[0])
    out, recorded, flips = {}, [], [0, 0]
    for impl in ("ref", None):
        eng = BatchedLeoAMEngine(
            cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=True,
                                   pipeline=True),
            device="cuda", impl=impl,
            store_root=str(KV_ROOT / f"e2e_{impl or 'cuda'}"))
        eng._theta = lambda li: 0.5    # θ comes from wall clock: pin it
        replay = None if impl == "ref" else iter(enumerate(recorded))
        select = eng._select_chunks_batched

        def select_fn(*a, _select=select, _replay=replay):
            sels, stats = _select(*a)
            if _replay is None:
                recorded.append(sels)
                return sels, stats
            i, want = next(_replay)
            flips[2 * i // len(recorded)] += sels != want
            return want, stats

        eng._select_chunks_batched = select_fn
        sid, tok = eng.add_sequence(prompt)
        logits = [eng.last_logits.copy()]
        toks = {sid: tok}
        for _ in range(2):
            toks = eng.decode_round(toks)
            logits.append(eng.last_logits[0].copy())
        out[impl] = logits
        eng.store.close()
        del eng, select, select_fn     # the patch closes a reference cycle
        gc.collect()
        torch.cuda.empty_cache()
    diffs = [float(np.abs(a - b).max()) for a, b in zip(out[None], out["ref"])]
    bars = [TOL_E2E_ULPS * _bf16_ulp(float(np.abs(b).max()))
            for b in out["ref"]]
    differ = [float((a != b).mean()) for a, b in zip(out[None], out["ref"])]
    same = [int(np.argmax(a)) == int(np.argmax(b))
            for a, b in zip(out[None], out["ref"])]
    print(f"[e2e] max |logit(kernels) - logit(plain)| prefill, round 1, "
          f"round 2: {diffs!r} (tol {TOL_E2E_ULPS} bf16 ulps of max|logit|: "
          f"{bars!r}); fraction of logits that differ {differ!r}; layers "
          f"whose own chunk selection would differ, per round: {flips} "
          f"(replayed); same argmax {same}")
    if not all(d <= b for d, b in zip(diffs, bars)):
        raise SystemExit("chip_smoke: end-to-end logits disagree")
    return diffs


T_START = time.perf_counter()


def only_kernels(argv):
    """The kernels that ``--only a,b`` (or ``--b2``) names; empty for the
    whole run."""
    names = set()
    for i, a in enumerate(argv):
        if a == "--b2":
            names.add("b2")
        elif a == "--only" and i + 1 < len(argv):
            names.update(argv[i + 1].split(","))
        elif a.startswith("--only="):
            names.update(a.split("=", 1)[1].split(","))
    unknown = names - set(KERNELS)
    if unknown:
        raise SystemExit(f"chip_smoke: --only takes {KERNELS}, not "
                         f"{sorted(unknown)}")
    return names


def only_phases(argv):
    """The engine phases that ``--phases 4h,4i`` names; empty for the
    whole run."""
    names = set()
    for i, a in enumerate(argv):
        if a == "--phases" and i + 1 < len(argv):
            names.update(argv[i + 1].split(","))
        elif a.startswith("--phases="):
            names.update(a.split("=", 1)[1].split(","))
    unknown = names - set(ENGINE_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: --phases takes {ENGINE_PHASES}, not "
                         f"{sorted(unknown)}")
    return names


def run_phases(np, torch, cfg, params, names):
    """``--phases``: the named engine phases alone, with their gates."""
    runners = {
        "4c": lambda: phase_admission(np, torch, cfg, params),
        "4d": lambda: _serve_modes(np, torch, cfg, params),
        "4e": lambda: phase_serve(np, torch, cfg, params, sidecar=True),
        "4f": lambda: phase_legacy(np, torch, cfg, params),
        "4g": lambda: phase_reopen(np, torch),
        "4h": lambda: phase_faults(np, torch, cfg, params),
        "4i": lambda: phase_preempt(np, torch, cfg, params)}
    try:
        for name in ENGINE_PHASES:
            if name in names:
                t0 = time.perf_counter()
                runners[name]()
                print(f"[time] phase {name} {time.perf_counter() - t0!r} s")
    finally:
        shutil.rmtree(KV_ROOT, ignore_errors=True)
    print(f"[time] chip_smoke {time.perf_counter() - T_START!r} s")
    return 0


def main() -> int:
    only = only_kernels(sys.argv[1:])
    phases = only_phases(sys.argv[1:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import lm

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)

    # phase 2: build
    t0 = time.perf_counter()
    build.library()
    print(f"[build] {time.perf_counter() - t0!r} s "
          f"({build.library_path().name})")

    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    if only:
        # the named kernels' timing lines alone: run from a checkout of
        # another commit to hold its kernels against this one's on one card
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
        print(f"[kernel] launch floor: one-element fill ms="
              f"{launch_floor_ms(torch, flush)!r}")
        if "b1" in only:
            print_row("chunk_bounds", b1_row(torch, flush))
        if "b2" in only:
            print_row("sparse_decode", b2_row(np, torch, rng, flush,
                                              MAIN_LENGTHS, MAX_LEN))
            print_row("sparse_decode at 32k",
                      b2_row(np, torch, np.random.RandomState(LONG_MAX_LEN),
                             flush, LONG_LENGTHS, LONG_MAX_LEN))
        if "b3" in only:
            slab = b3_slab(torch)
            print_row("kv_dequant", b3_row(np, torch, flush, slab, 16))
            print_row("kv_dequant at 48 chunks",
                      b3_row(np, torch, flush, slab, 48))
            del slab
        if "b5" in only:
            from repro_torch.kernels.pq import ops as pq
            x, cb = pq_random_inputs(np, torch)
            x = x[:, :114688].contiguous()
            print_row("pq_update", b5_row(torch, x, pq.pq_assign(x, cb),
                                          flush))
            print_row("pq_update on clustered keys",
                      b5_row(torch, *clustered_update_inputs(np, torch),
                             flush))
        return 0
    if not phases:
        rows, long_row, clustered, b3_48 = phase_kernels(np, torch, rng)
        pq_train_res = phase_pq_train(np, torch)

    cfg = get_config("longchat-7b-32k")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[init] longchat-7b-32k full width: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.dtype}, "
          f"{sum(p.numel() for p in _leaves(params)) / 1e9!r} G params in "
          f"{time.perf_counter() - t0!r} s")
    if phases:
        return run_phases(np, torch, cfg, params, phases)
    try:
        serve = phase_serve(np, torch, cfg, params)
        serve_pq = phase_serve(np, torch, cfg, params, pq=True)
        admission = phase_admission(np, torch, cfg, params)
        serve_async, serve_chunked = _serve_modes(np, torch, cfg, params)
        serve_sidecar = phase_serve(np, torch, cfg, params, sidecar=True)
        print(f"[serve-sidecar] disk->host kv beside phase 4's: "
              f"{json.dumps(serve_sidecar['disk_kv'])} against "
              f"{json.dumps(serve['disk_kv'])}")
        legacy = phase_legacy(np, torch, cfg, params)
        reopen = phase_reopen(np, torch)
        faults = phase_faults(np, torch, cfg, params)
        preempt = phase_preempt(np, torch, cfg, params)
        e2e = phase_e2e(np, torch, cfg, params)
    finally:
        shutil.rmtree(KV_ROOT, ignore_errors=True)

    src = "src/repro_torch/kernels/csrc/"
    meta = {
        "chunk_bounds": (src + "chunk_bounds.cu",
                         "src/repro/kernels/chunk_bounds/chunk_bounds.py:20"),
        "sparse_decode": (src + "sparse_decode.cu",
                          "src/repro/kernels/sparse_decode/sparse_decode.py:29"),
        "kv_dequant": (src + "kv_dequant.cu",
                       "src/repro/kernels/kv_quant/kv_quant.py:27"),
        "pq_assign": (src + "pq_kmeans.cu",
                      "src/repro/kernels/pq/pq_kmeans.py:32"),
        "pq_update": (src + "pq_kmeans.cu",
                      "src/repro/kernels/pq/pq_kmeans.py:65"),
    }
    # launches: B1-B3 from the minmax serve, B4/B5 from the PQ serve (the
    # path that runs them); each path's counts were zeroed just before it
    launches = {**serve["launches"],
                "pq_assign": serve_pq["launches"]["pq_assign"],
                "pq_update": serve_pq["launches"]["pq_update"]}
    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["bound"]) * 1e3,
            "bound_by": "bytes" if r["bound"][0] >= r["bound"][1]
            else "operations",
            "library_ms": r["library_ms"],
            **({"unfused_ms": r["unfused_ms"]} if "unfused_ms" in r
               else {})})
    print(f"[time] chip_smoke {time.perf_counter() - T_START!r} s")
    long_b2 = {k: v for k, v in long_row.items() if k != "bound"}
    long_b2["bound_ms"] = max(long_row["bound"]) * 1e3
    b5_clustered = {k: v for k, v in clustered.items() if k != "bound"}
    b5_clustered["bound_ms"] = max(clustered["bound"]) * 1e3
    b3_48c = {k: v for k, v in b3_48.items() if k != "bound"}
    b3_48c["bound_ms"] = max(b3_48["bound"]) * 1e3
    print(json.dumps({"kernels": kernels, "card": card, "e2e_max_diff": e2e,
                      "serve": serve, "serve_pq": serve_pq,
                      "admission": admission, "serve_async": serve_async,
                      "serve_chunked": serve_chunked,
                      "serve_sidecar": serve_sidecar, "legacy": legacy,
                      "reopen": reopen, "faults": faults,
                      "preempt": preempt,
                      "pq_train": pq_train_res,
                      "sparse_decode_32k": long_b2,
                      "pq_update_clustered": b5_clustered,
                      "kv_dequant_48": b3_48c}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cut_depth(cfg, params, n_layers):
    """longchat at ``n_layers`` of its depth: the same widths, its early
    (prologue) layers and the first body layers' weights (views of the
    full model's stacked leaves, no copy)."""
    import dataclasses
    from repro_torch.models import lm
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    repeats = lm._layer_plan(cut)[2]

    def head(tree):
        if isinstance(tree, dict):
            return {k: head(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(head(v) for v in tree)
        return tree[:repeats]

    return cut, {**params, "body": head(params["body"])}


def _serve_modes(np, torch, cfg, params):
    """Phase 4d's two serves at ``SERVE_MODES_LAYERS`` layers."""
    cut, cut_params = cut_depth(cfg, params, SERVE_MODES_LAYERS)
    print(f"[depth] phase 4d (serve-async, serve-chunked): "
          f"{SERVE_MODES_LAYERS} of {cfg.n_layers} layers, full width")
    return [phase_serve(np, torch, cut, cut_params, mode=m)
            for m in ("async", "chunked")]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
