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
   the kernels are); and, at phase 4k's shapes (deepseek-v2-lite's widths,
   no weights), B1's and B2's latent variants against their plain
   versions (max error beside its tolerance, ms, bound, plain ms, the
   library call: two q+/q- einsums for B1, gather + ``baddbmm`` + softmax
   + ``bmm`` for B2; B2 two launches bitwise equal; B1-latent one CUDA
   kernel a call, B2-latent two) and B3 into a one-plane (257, 1, 64, 1,
   576) slab, bitwise;
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
   no PQ fallback; at 8 of the 32 layers since phase 4m came (a
   ``[depth]`` line; phase 4k serves PQ at full depth on deepseek);
   4c. admission parity (8 of the 32 layers, a ``[depth]`` line): the
   serve's 1536- and 3584-token prompts, each
   admitted on four fresh engines — ``add_sequence``,
   ``add_sequence_async(...).result()``, ``begin_admission(...).drain()``
   and ``add_sequence`` with serial ingest (``overlap_ingest=False``)
   — and fenced: the overlapped admission must store the synchronous
   one's disk replica and min/max abstracts bit for bit, with the same
   first token; the serial one its replica, abstracts and device-pool
   contents bit for bit, with the same first token and ``overlapped``
   0.0 in its admit profile; the chunked one's first-token logits must lie within
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
   sidecar (``EngineCfg(disk_sidecar=True)``), at 8 of the 32 layers as
   phase 4d (a ``[depth]`` line says so): every ``kv_replica`` write
   and every disk->host ``kv`` read off the sidecar billed exactly
   ``chunk_bytes * codec_ratio("int4", 64)``; the only fp16 reads are of
   chunks a decode append invalidated (the reference bills those at fp16)
   and none falls back on a failed CRC;
   4f. (8 of the 32 layers, a ``[depth]`` line) the 1536- and
   3584-token prompts, 16 new tokens, served by the
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
   4h. the fault domain (8 of the 32 layers, a ``[depth]``
   line): the 1536- and 2048-token prompts admitted
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
   4i. preemption (8 of the 32 layers, a ``[depth]`` line): the 1536-
   and 2048-token prompts, 16 tokens each, with
   ``real_codec=False, pipeline=False``; the 2048-token sequence suspended
   after round 4 and resumed 4 rounds later, against a run that only
   leaves it out of those rounds: token streams identical, logits bitwise
   equal, pool slots freed on suspend, ``kv_swapout`` billed 0 bytes and
   ``kv_swapin`` the swapped-in chunks' bytes, B1/B2 launched after the
   resume; then the batcher (``max_active=2``, a pressure monitor) serves
   the 1536-, 2048- and 1536-token prompts with the third a high-priority
   request submitted after the first round: one request preempted and
   resumed, all three finished with 16 tokens, nothing leaked;
   4j. the shared-prefix cache (``EngineCfg(prefix_cache=True,
   prefill_chunk_tokens=512, prefix_arena_rows=4)``), at 8 of the 32
   layers (a ``[depth]`` line; the MLA model runs it at full depth in
   phase 4k): four
   prompts of one 3072-token head (48 chunks) and 100/228/356/484-token
   suffixes, each ending mid-chunk.  A parity pair with
   ``real_codec=False, pipeline=False``, 16 tokens: the cache-on engine
   admits the first two prompts (the second adopts 48 chunks and resumes
   at 3072), the cache-off engine admits them with
   ``begin_admission(...).drain()`` at the same 512: token streams
   identical, first-token and every round's logits bitwise equal, the
   adopter's prefix replica rows (its arena row's) bitwise equal to the
   cold engine's private rows, 48 zero-byte ``prefix_ref`` ops,
   ``bytes_deduped`` 48 x layers x (1 MiB + 16 KiB), two copy-on-writes
   (each tail's first append) billed ``cow_read`` and ``cow_copy`` at
   layers x 1 MiB each, B1/B2 launched.  Then the 4 prompts through the batcher
   (``max_active=4``, real int4 codec, pipeline on, 32 tokens): three
   warm admissions of 48 chunks, no private pool slot for an adopted
   chunk and shared chunks resident once in every layer's pool, no slab
   update that names a slot twice (B3's guard), no leak after release
   (arena chunks stay as zero-reference cache), B1-B3 launched.  Prints
   the warm and cold admission walls and TTFTs, ``prefix_stats()``, the
   host bytes of the fidelity rows (bf16) and the pool slots saved;
   4o. the engine's profile mode (8 of the 32 layers, a ``[depth]``
   line): the 1536- and 3584-token prompts, 16 new tokens, on three
   fresh engines — the defaults, ``profile=True`` (each layer's attend
   call timed between two synchronizations of the stream) and
   ``prefill_buckets=(1536, 2048, 3584, 4096)``; every profiled round has
   the keys of ``engine.ROUND_KEYS``, its measured ``attend_s`` within the rest of the round
   (+1 ms), the default engine ran the prefill shapes 2048 and 4096 and
   the scheduled one 1536 and 3584 (``prefill_programs`` 2 each), B1-B3
   launched in the profiled serve; prints the profiled split's mean and
   median (evaluate, gather, upload, measured attend, the rest) beside
   the default engine's remainder, and the three engines' token streams
   (not gated: θ reads measured costs, and other prefill shapes round
   otherwise, ROADMAP C8);
5. end to end against the plain versions: the first request's prefill and
   two decode rounds with ``impl="ref"``, then with the kernels replaying
   the plain run's chunk selections, logits held to a bf16 tolerance;
   4l. ``lm.decode_step``, the in-model sparse decode, at full width and
   depth (``[decode-step]``): 4 prompts of 3072 tokens prefilled into a
   4096-token cache with its abstract pyramid (3 levels), then 16 greedy
   steps with the plain versions (``impl="ref"``, each layer's chunk
   selection recorded) and again with kernels B1 and B2 (the selections
   replayed, the plain run's tokens fed): every step's logits within
   ``TOL_E2E_ULPS`` bf16 ulps of max|logit|, the first tokens the same,
   B2 launched once per layer and step and B1 at least as often; prints
   the median step, the peak device memory and the sparse-against-dense
   cosine of the first step's logits;
   4k. (after phase 5, longchat's parameters freed) the MLA latent path
   with no-drop MoE: deepseek-v2-lite-16b at full width (27 layers,
   d_model 2048, 16 heads, MLA 512 + 64, 64 experts top-6 + 2 shared,
   bf16 random weights from seed 0), ``max_len`` 4096, chunk 64 — the
   serve, the legacy pair and the end to end at all 27 layers, the PQ
   serve, the prefix runs, the sidecar serve, the fault run and admission
   parity at its first 9 (``MLA_CUT_LAYERS``, a ``[depth]`` line): the 4
   requests of phase 4 served as there (``[serve-mla]``:
   min/max abstracts, real int4 codec, pipeline on; the latent B1/B2 and
   B3 launch counters must move; init time and parameter count, peak
   device memory, TTFT, the median round's split, bytes by tier and
   kind); admission parity on the 1536- and 3584-token prompts as phase
   4c (``[admit-mla]``, chunked at 512 tokens a step, gated with the
   synchronous admission's expert choices replayed; the free-running
   logits gated too unless a row routed otherwise, and then the routing
   flips per layer must be shown to be rounding: the router inputs up to
   the first flipping layer within 4 bf16 ulps of the synchronous run's,
   every flipped row a near tie); ``pooled=False``
   against ``pooled=True`` as phase 4f (``[serve-legacy-mla]``, identical
   streams); end to end as phase 5 with the experts replayed too
   (``[e2e-mla]``); and, on one latent plane, the PQ serve
   (``[serve-pq-mla]``, gated as 4b; its streams printed beside the
   min/max serve's, not gated: ROADMAP C12), the shared-prefix pair and
   batcher serve as 4j (``[prefix-mla]``), the int4 sidecar serve with 4e's
   billing gate (``[serve-sidecar-mla]``) and a fault run with the sync
   sanitizer on (``[faults-mla]``, ``debug_sync=True``: a retried
   ``disk_read`` error, a quarantined sidecar read and a recomputed
   replica bitflip; counters, no failed sequence, no leak, the store's
   locks tracked);
   4m. (after 4k, one model on the card at a time, bf16 random weights
   from seed 0, ``max_len`` 4096, chunk 64) the A11 families at full
   width: jamba-1.5-large-398b at its first 4 of 72 layers (a
   ``[depth]`` line: three Mamba layers, then attention, ~46 GB of
   weights; a full 8-layer period would not fit) and qwen2-vl-2b (28
   layers) each serve phase 4's 4 requests with 16 new tokens
   (``[serve-jamba]``, ``[serve-qwen2-vl]``: min/max, real int4 codec,
   pipeline on; B1-B3 must launch), then plain against kernels as phase
   5 with selections and experts replayed, every kernel call of the
   first kernel round against its plain version (B1 within 1e-5, B2
   ``bf16_agreement``, B3 bitwise), logits within ``A11_E2E_BAR``;
   jamba's 2048-token sequence suspended for 2 rounds and resumed
   against a run that leaves it out (``[preempt-jamba]``: streams and
   logits bitwise, its Mamba state bitwise); qwen2-vl through
   ``lm.prefill`` with 3-D M-RoPE positions (a text head, a 16 x 16
   patch grid, a text tail) and seamless-m4t-large-v2 (24 + 24 layers,
   384 encoder frames, cross-attention) through ``lm.decode_step``, 8
   steps each, plain then B1/B2 replaying the selections, gated as 4l at
   ``A11_E2E_BAR`` (``[decode-qwen2-vl]``, ``[decode-seamless]``); and
   xlstm-125m prefilling 4 x 3072 tokens and decoding 16 steps, its last
   prefill logits against a decode step after prefill(S - 1)
   (``[xlstm]``);
   4n. (after 4m) the trainer, which runs no hand kernel (their launch
   counts, zeroed before, must still be 0): ``[train]`` qwen3-1.7b at
   full width and depth, bf16, through ``repro_torch.launch.train.main``
   (20 steps of 8 x 1024 tokens from ``ShardedLoader``, 2 microbatches,
   block remat; every loss finite, the last 4's mean ``TRAIN_LOSS_DROP``
   below the first 4's; the median step without step 0, tokens/s, peak
   memory, grad norms, lr, and one step's CUDA kernels and device busy
   share under torch.profiler); ``[train-resume]`` in a child process
   with ``torch.use_deterministic_algorithms(True)`` (qwen3 at 3 of 28
   layers, a ``[depth]`` line: save at step 3, three more steps, restore,
   the same steps — parameters, moments and step bitwise; then
   ``run_with_restarts`` with one injected failure: 1 restart, the final
   step 6, bitwise; the checkpoint's bytes, save and restore times);
   ``[train-moe]`` deepseek-v2-lite-16b at its first 3 of 27 layers
   (``[depth]``: MLA, the capacity-drop MoE, 64 experts top-6, bf16
   moments, 8 steps; finite losses and aux losses, each MoE layer's mean
   drop fraction in [0, 1), the loss falling); the child then runs phase
   4p's ``[mesh-train]``;
   4p. (after 4n) the device mesh (ROADMAP A12b) on the one card, longchat
   at 8 of 32 layers, full width (a ``[depth]`` line), 4 x 2560 tokens
   into a 4096-row cache, every rank building its weights from the seed:
   ``[mesh-1]`` a one-rank NCCL mesh in a child process —
   ``make_jitted_prefill`` and 16 ``make_jitted_decode`` steps bitwise
   equal to ``lm.prefill`` + ``lm.decode_step`` (over one rank the combine
   multiplies by exp(0) = 1); ``[mesh-4]`` four gloo ranks on the card,
   mesh (1, 4), 1024 rows a shard (shard 2 partly filled, shard 3 empty
   at every step): 8 steps plain recording each rank's selections, 8
   with B1 and B2 replaying them (logits within ``TOL_E2E_ULPS`` bf16
   ulps of max|logit|, the first tokens the same, B2 launched on every
   rank, the empty one included), and the dense decode within
   ``TOL_E2E_ULPS`` of the one-process local decode; ``[mesh-train]``
   (in 4n's deterministic child, or a child of its own under ``--phases
   4p``): qwen3 at 3 of 28 layers, 2 steps of ``make_jitted_train_step``
   on a one-rank NCCL mesh bitwise equal to 2 of ``make_train_step``;
   4q. (after 4p) the dry run (ROADMAP A12c, ``[dryrun]``): (a) in a
   child process, rank 0's step of three cells traced on fake CUDA
   tensors over a fake group of 256 on the production (16, 16) mesh
   (``repro_torch.launch.dryrun.lower_cell``): longchat-7b-32k x
   decode_32k (through B1's and B2's fake implementations),
   qwen3-1.7b x train_4k and deepseek-v2-lite-16b x decode_32k (MLA, the
   balanced MoE stand-in), each record and its roofline row printed; and
   the same rank's decode cell on a (1, 1) mesh; (b) that cell measured
   on the card — longchat at full width and depth, bf16 weights from seed
   0, rank 0's block of decode_32k on (16, 16) (8 sequences in a
   2048-row cache, chunk 64) on a one-rank NCCL mesh: the parameters
   DTensors by ``param_specs``, ``make_jitted_prefill`` of 8 x 2040
   tokens, then 8 ``make_jitted_decode`` steps at fills 2040-2047 on the
   kernels.  Gates: the last step (fill 2047, the step the dry run
   traces) counted by ``OpCounter`` on the card equals the (1, 1) record
   in FLOPs, bytes and collective counts; B1 and B2 launched; step 0's
   B1 and B2 calls each within its bar of its plain version
   (``check_decode_kernels``); ``max_memory_allocated`` over the decode
   steps within ``DRYRUN_PEAK_REL`` of the trace's peak.  Prints the
   median step, the roofline bound and the fraction of it the step
   reaches, and the card's busy share over one profiled step;
6. a ``kernels`` JSON line (B1-B5 and the two latent variants, each with
   the launches of the paths that run it, B1's and B2's with 4l's, 4m's,
   4o's profiled serve, every rank's of 4p and 4q's, B3's with 4m's and
   4o's serves, and
   the CUDA kernels one call launches, ``cuda_per_call``), then
   the result line
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --only b1,b2,b3,b5,latent`` runs phases 1-2 and the
timing lines of the named kernels only (``--b2`` is ``--only b2``;
``latent``: B1- and B2-latent at phase 4k's shapes), with no
result line; copied into a checkout of another commit, it holds that
commit's kernels against this one's on the same card.
``python3 chip_smoke.py --phases 4h,4i`` runs phases 1-2 and the named
engine phases of phase 4 (4c-4o) only, with their gates and no result
line (``--phases 4k``, ``4m``, ``4n``, ``4p`` or ``4q`` alone never
builds longchat in the parent).
"""

from __future__ import annotations

import contextlib
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
# the H100 SXM5 80GB's peaks (NVIDIA data sheet), one set for the port
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_S  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    PEAK_BF16, PEAK_F32, PEAK_TF32)
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
KERNELS = ("b1", "b2", "b3", "b5", "latent")  # what --only may name
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
# phase 4j: a 3072-token shared head (48 chunks) and four suffixes that
# end mid-chunk (prompts of 3172-3556 tokens), admitted chunked at 512
# tokens a step into a store with 4 arena rows
PREFIX_TOKENS, PREFIX_SUFFIXES, PREFIX_SEED = 3072, (100, 228, 356, 484), 19
PREFIX_CHUNK_TOKENS, PREFIX_ARENA_ROWS = 512, 4
ENGINE_PHASES = ("4c", "4d", "4e", "4f", "4g", "4h", "4i", "4j", "4o",
                 "4l", "4k", "4m", "4n", "4p", "4q")       # --phases
# phases that build their own models (longchat leaves the card before them)
OWN_MODEL_PHASES = ("4k", "4m", "4n", "4p", "4q")
# phase 4l: lm.decode_step on longchat at full width and depth, a batch of
# prompts of one length (decode_step takes one length for the batch), in
# a MAX_LEN cache (sparse: MAX_LEN >= min_seq_for_sparse, 3 pyramid
# levels), greedy steps
DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS, DECODE_SEED = 4, 3072, 16, 23
# phase 4k's fault run (debug_sync=True): the first sidecar read's first
# chunk is quarantined; its fp16 fallback read fails once (retried) and
# then flips a bit, so the chunk is recomputed from the prompt
MLA_FAULT_PLAN = {"sidecar_read": {0: "bitflip"},
                  "disk_read": {0: "io_error", 1: "bitflip"}}
# phase 4k: the MLA model, its chunked admission step, and the latent
# rows' widths (kv_lora_rank + qk_rope_head_dim; values the first 512)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_CHUNK_TOKENS = 512
# phase 4k runs its PQ, prefix, sidecar, fault and admission sub-phases at
# this many of deepseek's 27 layers (dense layer 0 and 8 MoE layers) to
# keep the script in its budget
MLA_CUT_LAYERS = 9
# phase 4m: the A11 families.  jamba at its published first 4 layers
# (three Mamba, then attention: ~46 GB of weights; a full 8-layer period
# would not fit the card), 16 new tokens a request; qwen2-vl's and
# seamless's decode_step runs over DECODE_BATCH prompts of A11_PROMPT
# rows (qwen2-vl's: a text head, a 16 x 16 patch grid, a text tail),
# A11_DECODE_STEPS steps; xlstm's A11_XLSTM_STEPS steps
A11_JAMBA, A11_JAMBA_LAYERS, A11_NEW_TOKENS = "jamba-1.5-large-398b", 4, 16
A11_PROMPT, A11_VISION_HEAD, A11_PATCH_GRID = 3072, 1024, 16
A11_DECODE_STEPS, A11_XLSTM_STEPS, A11_SEED = 8, 16, 29
# phase 4n: the trainer (ROADMAP A12a).  [train]: qwen3-1.7b at full width
# and depth through repro_torch.launch.train.main, bf16, remat "block",
# TRAIN_MICRO microbatches, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
# tokens from ShardedLoader (seed 1234) at the CLI's lr; the mean of the
# last 4 losses must lie TRAIN_LOSS_DROP below the mean of the first 4.
# [train-resume]: qwen3 at TRAIN_CUT_LAYERS layers, TRAIN_RESUME_STEPS
# steps, a save, as many again, restore, the same steps: bitwise.
# [train-moe]: deepseek-v2-lite at TRAIN_CUT_LAYERS layers (dense, MoE,
# one MoE body repeat), TRAIN_MOE_STEPS steps, the same drop margin
TRAIN_ARCH, TRAIN_MOE_ARCH = "qwen3-1.7b", "deepseek-v2-lite-16b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MICRO = 8, 1024, 20, 2
TRAIN_LR, TRAIN_LOSS_DROP = 1e-3, 0.5
TRAIN_CUT_LAYERS, TRAIN_RESUME_STEPS, TRAIN_MOE_STEPS = 3, 3, 8
TRAIN_CKPT_ROOT = ROOT / "build" / "chip_smoke_ckpt"
TRAIN_CHILD_FLAG = "--train-resume-child"
# phase 4m holds kernels against plain logits to phase 5's bar on longchat
# (4 bf16 ulps of its max|logit| in [4, 8)): each kernel call is held to
# its own bar beside it
A11_E2E_BAR = 0.125
# phase 4o: the engine's profile mode, new tokens a request, and the
# explicit bucket schedule of its third engine (the two prompts' own
# lengths and the powers of two above them)
PROFILE_NEW_TOKENS = 16
PROFILE_BUCKETS = (1536, 2048, 3584, 4096)
# phases 4b, 4c, 4d, 4e, 4f, 4h, 4i, 4j and 4o run this many of longchat's
# 32 layers
# (its 2 early layers and the first body layers, weights and widths
# unchanged) so that the whole script, phases 4l and 4k included, stays
# inside its time budget
SERVE_MODES_LAYERS = 8
# phase 4p: the device mesh (ROADMAP A12b) on the one card.  longchat at
# MESH_LAYERS of its 32 layers, full width, bf16 weights from seed 0 built
# by every rank; MESH_BATCH prompts of MESH_PROMPT tokens into a MAX_LEN
# cache.  [mesh-1]: a one-rank NCCL mesh, MESH_STEPS decode steps;
# [mesh-4]: four gloo ranks on the card, mesh (1, 4) of MAX_LEN / 4 rows a
# shard (shard 2 partly filled, shard 3 empty), MESH_SHARD_STEPS steps
# plain, then with the kernels, then dense.  [mesh-train] runs in the
# deterministic child of 4n (qwen3 at TRAIN_CUT_LAYERS layers): 2 steps on
# a one-rank NCCL mesh against 2 steps without one
MESH_LAYERS, MESH_BATCH, MESH_PROMPT, MESH_SEED = 8, 4, 2560, 31
MESH_STEPS, MESH_SHARD_STEPS, MESH_TRAIN_STEPS = 16, 8, 2
MESH_TIMEOUT_S = 600
MESH_TRAIN_ONLY_FLAG = "--mesh-train-only"
# phase 4q: the dry run.  (a) these cells on the (16, 16) mesh, traced in
# a child process; (b) longchat's decode_32k cell as rank 0 holds it on
# (16, 16) — DRYRUN_BATCH rows of the batch, a cache block of DRYRUN_ROWS
# rows — measured on a one-rank mesh: prompts of DRYRUN_PROMPT tokens,
# then DRYRUN_STEPS steps at fills DRYRUN_PROMPT .. DRYRUN_ROWS - 1.  The
# card's peak over the steps must lie within DRYRUN_PEAK_REL of the
# trace's
DRYRUN_CELLS = (("longchat-7b-32k", "decode_32k"), ("qwen3-1.7b", "train_4k"),
                ("deepseek-v2-lite-16b", "decode_32k"))
DRYRUN_ARCH, DRYRUN_SHAPE = "longchat-7b-32k", "decode_32k"
DRYRUN_PROMPT, DRYRUN_STEPS, DRYRUN_SEED = 2040, 8, 37
DRYRUN_PEAK_REL = 0.10
DRYRUN_CHILD_FLAG = "--dryrun-child"
DRYRUN_TIMEOUT_S = 600
SLEEP_CYCLES = 4_000_000    # ~2 ms at the H100's boost clock
# CUDA kernels one call of each latent variant launches
LATENT_CUDA_PER_CALL = {"chunk_bounds_latent": 1, "sparse_decode_latent": 2}


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
    ops, nbytes = cb.cost_chunk_bounds_gqa(q, km, kn)
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
    ops, nbytes = sd.cost_sparse_decode_pooled(*args[:-1],
                                               live_rows=live_rows)
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
    if planes > 1:
        kv[:, 1] *= 0.5                              # V apart from K

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
        shape=f"{n} chunks x {planes} plane(s) of c={c} d={H * hd} int4 -> "
              f"fp16 into "
              f"{n} permuted slots of a ({S}, {planes}, {c}, {H}, {hd}) "
              f"slab; {'fused' if fused else 'kv_dequant + index put'}")


def _n_cuda_kernels(r) -> int:
    """The CUDA kernels (not copies) one call of a row's kernel launches."""
    return sum(not n.startswith("Memcpy") for n, _, _ in r["cuda_per_call"])


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
    n_kernels = _n_cuda_kernels(r)
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
                mode: str = "sync", sidecar: bool = False,
                tag: str | None = None, new_tokens: int = NEW_TOKENS):
    """A main path: 4 requests through the batcher, counters checked.
    ``pq`` turns on the PQ abstract plane (phase 4b): B4 and B5 train and
    encode at ingest, evaluation scores code-valid chunks by ADC.
    ``mode`` is the admission (phase 4d): ``"async"`` is
    ``SchedulerCfg(overlap_admission=True)``, ``"chunked"``
    ``chunked_admission=True`` with ``CHUNKED_ROUND_TOKENS`` prompt tokens
    between two rounds.  ``sidecar`` turns on the packed int4 disk
    sidecar (phase 4e) and gates its billing.  An MLA model (phase 4k)
    gates the latent variants of B1 and B2 in place of B1 and B2."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.pq import ops as pqk
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                               SchedulerCfg)

    tag = tag or ("[serve-pq]" if pq else "[serve-sidecar]" if sidecar
                  else "[serve]" if mode == "sync" else f"[serve-{mode}]")
    mla = cfg.mla is not None
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
    cb.latent_launches = sd.latent_launches = 0
    pqk.assign_launches = pqk.update_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=new_tokens))
    finished = batcher.run()
    eng.store.requant_fence()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chunk_bounds": cb.launches, "sparse_decode": sd.launches,
                "kv_dequant": kq.launches, "pq_assign": pqk.assign_launches,
                "pq_update": pqk.update_launches}
    if mla:
        launches.update(chunk_bounds_latent=cb.latent_launches,
                        sparse_decode_latent=sd.latent_launches)
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
        if len(r.out) != new_tokens or not all(
                0 <= t < cfg.vocab_size for t in r.out):
            raise SystemExit(f"chip_smoke: request {r.rid} gave {r.out}")
    path = [*_path_kernels(cfg), "kv_dequant"] + (
        ["pq_assign", "pq_update"] if pq else [])
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
            "pq_reencodes": faults["pq_reencodes"],
            "streams": {str(r.rid): list(r.out) for r in finished}}


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


def _path_kernels(cfg):
    """The evaluate and attend kernels of a model's decode round: B1 and
    B2, or their latent variants for MLA."""
    return (("chunk_bounds_latent", "sparse_decode_latent")
            if cfg.mla is not None else ("chunk_bounds", "sparse_decode"))


def _round_launches():
    """B1, B2 (and their latent variants) and B3 since the last zeroing."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    return {"chunk_bounds": cb.launches, "sparse_decode": sd.launches,
            "kv_dequant": kq.launches,
            "chunk_bounds_latent": cb.latent_launches,
            "sparse_decode_latent": sd.latent_launches}


def phase_legacy(np, torch, cfg, params, tag="[serve-legacy]"):
    """Phase 4f: the serve's shortest and longest prompts, driven through
    the engine with ``pooled=False`` (the working set assembled on the host
    and uploaded whole every round; B2 reads it in place) and with
    ``pooled=True``, both ``real_codec=False, pipeline=False``.  The two
    must give identical token streams.  For MLA (phase 4k) the working set
    is one latent plane, uploaded once."""
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
                upload[0] += kg.nbytes + (0 if vg is kg else vg.nbytes)
                return kg, vg, nsel

            eng.store.fetch_chunks_batch = counted
        cb.launches = sd.launches = kq.launches = 0
        cb.latent_launches = sd.latent_launches = 0
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
            "launches": {k: v for k, v in _round_launches().items()
                         if k in (*_path_kernels(cfg), "kv_dequant")},
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
    print(f"{tag} {json.dumps(row)}")
    bad = []
    if not same:
        bad.append(f"token streams differ: {leg['streams']} vs "
                   f"{poo['streams']}")
    if any(leg["launches"][k] <= 0 for k in _path_kernels(cfg)):
        bad.append(f"the legacy serve did not launch "
                   f"{_path_kernels(cfg)}: {leg['launches']}")
    if bad:
        raise SystemExit(f"chip_smoke: {tag} " + "; ".join(bad))
    return row


def phase_profile(np, torch, cfg, params, tag="[profile]"):
    """Phase 4o: the serve's shortest and longest prompts, 16 new tokens
    each, on three fresh engines: (a) the defaults, (b) ``profile=True``
    (each layer's attend call timed behind stream synchronizations), (c)
    ``prefill_buckets=PROFILE_BUCKETS``.  Gates: every round of (b) has
    the keys of ``engine.ROUND_KEYS`` and its measured ``attend_s`` fits in the rest of the
    round; (a) ran the two power-of-two prefill shapes and (c) the two
    scheduled ones (``prefill_programs`` 2 each); B1, B2 and B3 launched in
    (b).  Prints (b)'s split (evaluate, gather, upload, measured attend,
    the rest) beside (a)'s remainder, and the token streams, which are not
    gated: θ reads measured costs, and (c)'s other GEMM shapes round
    otherwise (ROADMAP C8)."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompts = serve_prompts(np, cfg)
    prompts = [prompts[0], prompts[-1]]
    runs = {"a": {}, "b": {"profile": True},
            "c": {"prefill_buckets": PROFILE_BUCKETS}}
    res = {}
    for name, extra in runs.items():
        root = KV_ROOT / f"profile-{name}"
        eng = BatchedLeoAMEngine(
            cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=True,
                                   pipeline=True, **extra),
            max_seqs=len(prompts), device="cuda", store_root=str(root))
        _zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, streams = {}, {}
        for p in prompts:
            sid, tok = eng.add_sequence(p)
            toks[sid], streams[sid] = tok, [tok]
        for _ in range(PROFILE_NEW_TOKENS - 1):
            toks = eng.decode_round(toks)
            for sid, tok in toks.items():
                streams[sid].append(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = [dict(r) for r in eng.round_profiles]
        res[name] = {
            "streams": [streams[s] for s in sorted(streams)],
            "rounds": rounds, "wall_s": wall,
            "programs": eng.prefill_programs,
            "shapes": sorted(eng._prefill_shapes),
            "launches": {k: v for k, v in _round_launches().items()
                         if k in (*_path_kernels(cfg), "kv_dequant")},
            "ttft_s": [a["total_s"] for a in eng.admit_profiles]}
        eng.store.close()
        del eng
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()

    def _stats(xs):
        return {"mean": float(np.mean(xs)), "median": float(np.median(xs))}

    def split(rounds, measured):
        out = {k: _stats([r[k] for r in rounds])
               for k in ("total_s", "eval_s", "gather_s", "upload_s")}
        rest = [r["total_s"] - r["eval_s"] - r["gather_s"] - r["upload_s"]
                - (r["attend_s"] if measured else 0.0) for r in rounds]
        out["attend_s" if measured else "remainder_s"] = _stats(
            [r["attend_s"] for r in rounds])
        if measured:
            out["rest_s"] = _stats(rest)
        return out

    from repro_torch.serving.engine import ROUND_KEYS
    a, b, c = res["a"], res["b"], res["c"]
    keys = set(ROUND_KEYS)
    over = [r["attend_s"] - (r["total_s"] - r["eval_s"] - r["gather_s"]
                             - r["upload_s"]) for r in b["rounds"]]
    row = {"prompts": [len(p) for p in prompts],
           "new_tokens": PROFILE_NEW_TOKENS,
           "profiled_split": split(b["rounds"], True),
           "default_split": split(a["rounds"], False),
           "attend_over_rest_max_s": max(over),
           "streams": {k: r["streams"] for k, r in res.items()},
           "streams_a_b_identical": a["streams"] == b["streams"],
           "streams_a_c_identical": a["streams"] == c["streams"],
           "prefill_programs": {k: r["programs"] for k, r in res.items()},
           "prefill_shapes": {k: r["shapes"] for k, r in res.items()},
           "ttft_s": {k: r["ttft_s"] for k, r in res.items()},
           "wall_s": {k: r["wall_s"] for k, r in res.items()},
           "launches": {k: r["launches"] for k, r in res.items()}}
    print(f"{tag} {json.dumps(row)}")
    bad = []
    if any(set(r) != keys for r in b["rounds"]):
        bad.append(f"round profile keys {[sorted(r) for r in b['rounds']]}")
    if max(over) > 1e-3:
        bad.append(f"measured attend exceeds the rest of a round by "
                   f"{max(over)} s")
    if a["shapes"] != [2048, 4096] or a["programs"] != 2:
        bad.append(f"default engine's prefill shapes {a['shapes']}")
    if c["shapes"] != [1536, 3584] or c["programs"] != 2:
        bad.append(f"scheduled engine's prefill shapes {c['shapes']}")
    if any(b["launches"][k] <= 0 for k in b["launches"]):
        bad.append(f"the profiled serve did not launch every kernel: "
                   f"{b['launches']}")
    if bad:
        raise SystemExit(f"chip_smoke: {tag} " + "; ".join(bad))
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


@contextlib.contextmanager
def _moe_routes(torch, record=None, replay=None, rows=None, flips=None,
                inputs=None):
    """Inside the block the MoE router (``mlp.moe_route``) records each
    call's experts into ``record`` (and into ``inputs`` its input rows and
    router probabilities, when given), or replays ``replay``: call k takes the
    experts of recorded call ``rows(k)[0]``, rows ``rows(k)[1]`` (default:
    call k, every row), with its own router probabilities renormalized over
    them.  Random weights put many tokens' 6th and 7th experts within a
    bf16 rounding of each other, so a GEMM of another shape can swap one;
    replaying holds those discrete choices equal, as phase 5 does with the
    chunk selections, so a comparison sees the arithmetic alone.
    ``flips`` gets, per replayed call, the rows whose own choice would
    differ."""
    from repro_torch.models import mlp
    own = mlp.moe_route
    calls = [0]

    def route(p, cfg, xf):
        top_p, top_e = own(p, cfg, xf)
        k = calls[0]
        calls[0] += 1
        if replay is None:
            record.append(top_e.clone())
            if inputs is not None:
                inputs.append((xf.clone(), torch.softmax(
                    xf.float() @ p["router"].float(), dim=-1)))
            return top_p, top_e
        j, sl = rows(k) if rows else (k, slice(None))
        want = replay[j][sl]
        if flips is not None:
            flips.append(int((top_e.sort(-1).values != want.sort(-1).values)
                             .any(-1).sum()))
        w = torch.softmax(xf.float() @ p["router"].float(), dim=-1).gather(
            1, want)
        return w / w.sum(-1, keepdim=True), want

    mlp.moe_route = route
    try:
        yield
    finally:
        mlp.moe_route = own


def _route_flips(whole, chunked, n_moe, C, S):
    """Rows of a chunked prefill whose experts differ from the whole
    prompt's, per MoE layer (prompt rows only)."""
    out = [0] * n_moe
    for k, got in enumerate(chunked):
        j, i = k % n_moe, k // n_moe
        lo = i * C
        n = max(0, min(C, S - lo))
        want = whole[j][lo:lo + n].sort(-1).values
        out[j] += int((got[:n].sort(-1).values != want).any(-1).sum())
    return out


def _route_witness(torch, routes, inputs, flips, n_moe, C, S):
    """A second witness, beside the replay, that the free-running chunked
    admission's routing flips are bf16 rounding.  Up to the first MoE
    layer with a flip every earlier MoE layer routed each row alike, so
    the router's input rows differ by arithmetic alone: their largest
    difference in bf16 ulps of each row's largest value, per layer, held
    to ``TOL_E2E_ULPS``.  At that layer: each flipped row's margin in the
    synchronous run between its k-th and (k+1)-th router probabilities,
    beside its largest change of a router probability (a swap needs
    margin <= 2 x change: the records are checked against it), and the
    median margin of all rows."""
    first = next((j for j, f in enumerate(flips) if f), None)
    if first is None:
        return {"first_flip_moe_layer": None, "ok": False}

    def layer(j):
        ns = [min(C, S - i * C) for i in range(-(-S // C))]
        parts = [(inputs["chunked"][i * n_moe + j],
                  routes["chunked"][i * n_moe + j]) for i in range(len(ns))]
        xc = torch.cat([x[:n] for n, ((x, _), _) in zip(ns, parts)])
        pc = torch.cat([q[:n] for n, ((_, q), _) in zip(ns, parts)])
        ec = torch.cat([e[:n] for n, (_, e) in zip(ns, parts)])
        xs, ps = inputs["sync"][j]
        return xs[:S], ps[:S], routes["sync"][j][:S], xc, pc, ec

    ulps = []
    for j in range(first + 1):
        xs, ps, es, xc, pc, ec = layer(j)
        xs = xs.float()
        top = xs.abs().amax(-1).clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
        ulps.append(float(((xc.float() - xs).abs().amax(-1) / ulp).max()))
    K = es.shape[-1]
    srt = ps.sort(-1, descending=True).values
    margin = srt[:, K - 1] - srt[:, K]
    flipped = (es.sort(-1).values != ec.sort(-1).values).any(-1)
    dp = (pc - ps).abs().amax(-1)
    consistent = bool((margin[flipped] <= 2 * dp[flipped]).all())
    return {"first_flip_moe_layer": first, "input_max_ulps": ulps,
            "input_ulps_bar": TOL_E2E_ULPS, "flipped_rows": int(flipped.sum()),
            "flipped_margin_max": float(margin[flipped].max()),
            "flipped_dprob_max": float(dp[flipped].max()),
            "all_rows_margin_median": float(margin.median()),
            "all_rows_dprob_max": float(dp.max()),
            "consistent": consistent,
            "ok": consistent and max(ulps) <= TOL_E2E_ULPS}


def _pool_contents(store):
    """Each layer's pool: its slot map and the slab rows of those slots
    (on the card)."""
    out = []
    for pool in store.pools:
        items = sorted(pool.slot_of.items())
        idx = [slot for _, slot in items]
        out.append((items, pool.kv[idx].clone()))
    return out


def phase_admission(np, torch, cfg, params, tag="[admit]",
                    chunk_tokens=None, serial=True):
    """Phase 4c: two of the serve's prompts, each admitted on fresh
    engines (sync, async, chunked, ``chunk_tokens`` a step when given, and
    with ``serial`` a synchronous admission with ``overlap_ingest=False``),
    every store fenced, then held against the synchronous admission.  The
    serial admission must store the synchronous one's replica, abstracts
    and pool contents bit for bit and report ``overlapped`` 0.0.  For
    an MoE model the chunked admission runs twice: free, with the routing
    flips against the whole prompt per layer, and with the synchronous
    admission's expert choices replayed.  The replay's first-token logits
    are gated; the free run's are too, unless it routed a row otherwise,
    and then :func:`_route_witness` must show the flips are rounding."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompts = serve_prompts(np, cfg)
    moe = cfg.moe is not None
    n_moe = sum(m == "moe" for m in cfg.mlp_kinds())
    out = []
    for p in (prompts[0], prompts[-1]):
        S = len(p)
        res = {}
        routes = {"sync": [], "chunked": []}
        inputs = {"sync": [], "chunked": []}
        for mode in ("sync", "async", "chunked") + (
                ("serial",) if serial else ()) + (
                ("chunked_replay",) if moe else ()):
            root = KV_ROOT / f"admit_{S}_{mode}"
            step = {} if chunk_tokens is None else \
                {"prefill_chunk_tokens": chunk_tokens}
            if mode == "serial":
                step["overlap_ingest"] = False
            eng = BatchedLeoAMEngine(
                cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=True,
                                       pipeline=True, **step),
                device="cuda", store_root=str(root))
            admits = []
            _spy_admissions(eng, admits)
            C = eng.ecfg.prefill_chunk_tokens
            if mode == "chunked_replay":
                spy = _moe_routes(torch, replay=routes["sync"],
                                  rows=lambda k, C=C: (
                                      k % n_moe, slice(k // n_moe * C,
                                                       (k // n_moe + 1) * C)))
            elif moe and mode in routes:
                spy = _moe_routes(torch, record=routes[mode],
                                  inputs=inputs[mode])
            else:
                spy = contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with spy:
                if mode in ("sync", "serial"):
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
                C=eng.ecfg.prefill_chunk_tokens,
                pool=(_pool_contents(st) if mode in ("sync", "serial")
                      else None))
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
        se = res.get("serial")
        if se is not None:
            rse = replica(se)
            se_equal = {
                "replica": all(np.array_equal(rs[li], rse[li])
                               for li in range(rs.shape[0])),
                "abstracts": (np.array_equal(sync["km"], se["km"])
                              and np.array_equal(sync["kn"], se["kn"])),
                "pool": all(a[0] == b[0] and torch.equal(a[1], b[1])
                            for a, b in zip(sync["pool"], se["pool"])),
                "first_token": se["tok"] == sync["tok"]}
            del rse
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
        # the gated chunked admission: with routing replayed for MoE
        gated = res.get("chunked_replay", ch)
        gated_logit = float(np.abs(gated["logits"] - sync["logits"]).max())
        want_steps = -(-S // ch["C"])
        if moe:
            flips = _route_flips(routes["sync"], routes["chunked"], n_moe,
                                 ch["C"], S)
            witness = _route_witness(torch, routes, inputs, flips, n_moe,
                                     ch["C"], S)
        inputs.clear()
        row = {"prompt": S, "first_token": {m: r["tok"] for m, r in
                                            res.items()},
               "overlap_replica_bitwise": ov_equal,
               "overlap_abstracts_bitwise": abs_equal,
               "overlap_max_logit_diff": ov_logit,
               "chunked_max_logit_diff": ch_logit, "logit_tol": bar,
               "chunked_max_replica_diff": ch_diff,
               **({"chunked_routing_flips_per_layer": flips,
                   "chunked_witness": witness,
                   "replayed_max_logit_diff": gated_logit,
                   "replayed_first_token": gated["tok"]}
                  if moe else {}),
               **({"serial_bitwise": se_equal,
                   "serial_overlapped": se["profile"]["overlapped"]}
                  if se is not None else {}),
               "chunked_replica_fraction_differ": ch_frac,
               "chunked_max_abstract_diff": ch_abs,
               "async_threads": ov["threads"], "chunked_steps": ch["steps"],
               "chunked_steps_expected": want_steps,
               "admit_wall_s": {m: r["wall"] for m, r in res.items()},
               "admit_profile": {m: r["profile"] for m, r in res.items()}}
        print(f"{tag} {json.dumps(row)}")
        for m in res:
            shutil.rmtree(KV_ROOT / f"admit_{S}_{m}", ignore_errors=True)
        fails = []
        if not (ov_equal and abs_equal and ov["tok"] == sync["tok"]):
            fails.append("overlapped admission differs from synchronous")
        if se is not None and not all(se_equal.values()):
            fails.append(f"serial-ingest admission differs from the "
                         f"synchronous one: {se_equal}")
        if se is not None and se["profile"]["overlapped"] != 0.0:
            fails.append(f"serial-ingest admission reports overlapped "
                         f"{se['profile']['overlapped']}")
        if gated_logit > bar:
            fails.append("chunked first-token logits beyond the bar"
                         + (" with routing replayed" if moe else ""))
        if moe and ch_logit > bar and not witness["ok"]:
            fails.append("free-running chunked first-token logits beyond "
                         "the bar, and the routing flips not shown to be "
                         "rounding")
        if not (len(ov["threads"]) == 1
                and ov["threads"][0].startswith("leoam-admit")):
            fails.append(f"async admission ran on {ov['threads']}")
        if sync["threads"] != ["MainThread"] or ch["threads"] or (
                se is not None and se["threads"] != ["MainThread"]):
            fails.append(f"sync/chunked/serial admission threads "
                         f"{sync['threads']} {ch['threads']} "
                         f"{se['threads'] if se is not None else None}")
        if ch["steps"] != want_steps:
            fails.append(f"chunked admission took {ch['steps']} steps")
        if fails:
            raise SystemExit(f"chip_smoke: {tag} admission parity at "
                             f"S={S}: " + "; ".join(fails))
        out.append(row)
    return out


def _launch_counts(cfg=None):
    """B1, B2 and B3 launches since the last zeroing — for an MLA
    ``cfg``, B1's and B2's latent variants in their place."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    if cfg is not None and cfg.mla is not None:
        return {"chunk_bounds_latent": cb.latent_launches,
                "sparse_decode_latent": sd.latent_launches,
                "kv_dequant": kq.launches}
    return {"chunk_bounds": cb.launches, "sparse_decode": sd.launches,
            "kv_dequant": kq.launches}


def _zero_launches():
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.sparse_decode import ops as sd
    cb.launches = sd.launches = kq.launches = 0
    cb.latent_launches = sd.latent_launches = 0


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


def prefix_prompts(np, cfg):
    """Phase 4j's prompts: one ``PREFIX_TOKENS`` shared head, then each of
    ``PREFIX_SUFFIXES`` fresh tokens (every prompt ends mid-chunk)."""
    rng = np.random.RandomState(PREFIX_SEED)
    head = rng.randint(2, cfg.vocab_size, PREFIX_TOKENS)
    return [np.concatenate([head, rng.randint(2, cfg.vocab_size, n)])
            for n in PREFIX_SUFFIXES]


def _prefix_engine(cfg, params, root, *, cache, real_codec, pipeline,
                   max_seqs):
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    return BatchedLeoAMEngine(
        cfg, params,
        EngineCfg(max_len=MAX_LEN, real_codec=real_codec, pipeline=pipeline,
                  prefix_cache=cache, prefill_chunk_tokens=PREFIX_CHUNK_TOKENS,
                  prefix_arena_rows=PREFIX_ARENA_ROWS),
        max_seqs=max_seqs, device="cuda", store_root=str(root))


def _prefix_leaks(eng):
    """``_engine_leaks`` for a prefix-cache engine: released arena chunks
    stay in the pool as zero-reference cache, so the pool may hold arena
    rows' chunks and nothing else."""
    st = eng.store
    leaks = [x for x in _engine_leaks(eng) if not x.startswith("pool")]
    if st.prefix_stats().get("shared_refs", 0):
        leaks.append(f"live refs {st.prefix_stats()['shared_refs']}")
    private = sum(k[0] < st.n_seqs for p in st.pools for k in p.slot_of)
    if private:
        leaks.append(f"{private} private pool slots")
    return leaks


def _fidelity_bytes(st):
    return sum(t.numel() * t.element_size()
               for kv in st._fidelity.values() for t in kv)


def _prefix_pair_run(np, torch, cfg, params, prompts, cache, ref_rows):
    """One engine of 4j's parity pair: the first two prompts admitted
    (chunked: through ``add_sequence`` with the cache on, through
    ``begin_admission(...).drain()`` with it off), then decoded to
    ``FAULT_NEW_TOKENS`` tokens with ``real_codec=False,
    pipeline=False``.  With the cache on it returns the adopter's prefix
    replica rows (its arena row's); with it off it compares its own rows
    with ``ref_rows`` layer by layer."""
    root = KV_ROOT / f"prefix_{'on' if cache else 'off'}"
    eng = _prefix_engine(cfg, params, root, cache=cache, real_codec=False,
                         pipeline=False, max_seqs=2)
    st = eng.store
    _zero_launches()
    cur, first, admit_s = {}, {}, []
    for p in prompts[:2]:
        t0 = time.perf_counter()
        sid, tok = eng.add_sequence(p) if cache else \
            eng.begin_admission(p).drain()
        torch.cuda.synchronize()
        admit_s.append(time.perf_counter() - t0)
        cur[sid] = tok
        first[sid] = eng.seqs[sid].prefill_logits.copy()
    streams = {sid: [t] for sid, t in cur.items()}
    logits = []
    while any(len(s) < FAULT_NEW_TOKENS for s in streams.values()):
        cur = eng.decode_round(cur)
        logits.append(eng.last_logits.copy())
        for sid, t in cur.items():
            streams[sid].append(t)
    torch.cuda.synchronize()
    launches = _launch_counts(cfg)
    st.ingest_fence_all()
    adopter = max(streams)
    n_shared = PREFIX_TOKENS // eng.chunk
    log = st.log
    info = {"admit_s": admit_s, "launches": launches,
            "resident_slots": sum(len(p.slot_of) for p in st.pools),
            "chunk_bytes": st.chunk_bytes,
            "abstract_bytes": st.abstract_bytes}
    rows = None
    if cache:
        row = st._shared_map[adopter][0]
        info.update(
            adopter_rows=sorted({st._shared_map[adopter].get(c)
                                 for c in range(n_shared)}),
            prefix_ref_ops=log.ops.get(("host", "disk", "prefix_ref"), 0),
            prefix_ref_bytes=log.bytes.get(("host", "disk", "prefix_ref"),
                                           0.0),
            cow_copies=st.cow_copies,
            cow_read=[log.ops.get(("disk", "host", "cow_read"), 0),
                      log.bytes.get(("disk", "host", "cow_read"), 0.0)],
            cow_copy=[log.ops.get(("host", "disk", "cow_copy"), 0),
                      log.bytes.get(("host", "disk", "cow_copy"), 0.0)],
            prefix_stats=st.prefix_stats(),
            fidelity_bytes=_fidelity_bytes(st),
            hit_tokens=[a.get("prefix_hit_tokens")
                        for a in eng.admit_profiles])
        rows = np.array(st._disk[row, :, :n_shared])
    else:
        info["rows_bitwise"] = all(
            np.array_equal(ref_rows[li], st._disk[adopter, li, :n_shared])
            for li in range(st.n_layers))
    for sid in list(streams):
        eng.release(sid)
    info["leaks"] = _prefix_leaks(eng)
    st.close()
    del eng, st
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return streams, first, logits, info, rows


def _prefix_serve(np, torch, cfg, params, prompts):
    """4j's batcher serve: the 4 prompts through ``ContinuousBatcher(
    SchedulerCfg(max_active=4, chunk=64))`` with the real int4 codec and
    the pipeline on.  After every round, each live sequence's adopted
    chunks must hold no private pool slot; every slab update must name
    each slot once (the guard raises otherwise), and some carry arena
    chunks."""
    from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                               SchedulerCfg)
    root = KV_ROOT / "prefix_serve"
    eng = _prefix_engine(cfg, params, root, cache=True, real_codec=True,
                         pipeline=True, max_seqs=len(prompts))
    st = eng.store
    scat = {"calls": 0, "repeated": 0, "with_arena": 0, "arena_slots": 0}
    for pool in st.pools:
        def spy(slots, *a, _pool=pool, _scatter=pool.scatter, **kw):
            if len(slots):
                key_of = {s: k for k, s in _pool.slot_of.items()}
                arena = sum(key_of[s][0] >= st.n_seqs for s in slots
                            if s in key_of)
                scat["calls"] += 1
                scat["repeated"] += len(slots) - len(set(slots))
                scat["with_arena"] += arena > 0
                scat["arena_slots"] += arena
            return _scatter(slots, *a, **kw)
        pool.scatter = spy
    # per round: private slots held for adopted chunks (must stay 0), the
    # fewest shared arena chunks resident in any layer's pool (the best
    # round kept), and the slots a store without sharing would add
    check = {"rounds": 0, "private_adopted": 0, "shared_resident": 0,
             "max_slots_saved": 0}
    decode_round = eng.decode_round

    def checked_round(tokens):
        out = decode_round(tokens)
        readers = {}
        for sid in eng.seqs:
            for c, row in (st._shared_map.get(sid) or {}).items():
                readers[(row, c)] = readers.get((row, c), 0) + 1
                check["private_adopted"] += sum(
                    (sid, c) in p.slot_of for p in st.pools)
        shared = [sum(n > 1 for k, n in readers.items() if k in p.slot_of)
                  for p in st.pools]
        saved = sum(n - 1 for p in st.pools for k, n in readers.items()
                    if k in p.slot_of)
        check["rounds"] += 1
        check["shared_resident"] = max(check["shared_resident"], min(shared))
        check["max_slots_saved"] = max(check["max_slots_saved"], saved)
        return out

    eng.decode_round = checked_round
    b = ContinuousBatcher(engine=eng, cfg=SchedulerCfg(max_active=4, chunk=64))
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=p, max_new=NEW_TOKENS))
    done = b.run()
    st.requant_fence()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(cfg)
    stats = b.stats()
    pstats = st.prefix_stats()
    res = {"wall_s": wall, "launches": launches,
           "ttft_s": {str(r.rid): r.t_first - r.t_submit for r in done
                      if r.t_first is not None},
           "admissions": [{k: a.get(k) for k in
                           ("total_s", "prefill_s", "ingest_s", "chunks",
                            "prefix_hit_tokens")}
                          for a in eng.admit_profiles],
           "mean_ttft_s": stats.get("mean_ttft_s"),
           "median_round_s": float(np.median(
               [p["total_s"] for p in eng.round_profiles])),
           "prefix_stats": pstats, "fidelity_bytes": _fidelity_bytes(st),
           "cow_read_bytes": st.log.bytes.get(("disk", "host", "cow_read"),
                                              0.0),
           "scatter": scat, "pool_check": check,
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    fails = []
    if sorted(r.rid for r in done) != list(range(len(prompts))) or any(
            r.error or len(r.out) != NEW_TOKENS for r in done):
        fails.append(f"serve requests "
                     f"{[(r.rid, r.error, len(r.out)) for r in done]}")
    n_shared = PREFIX_TOKENS // eng.chunk
    if pstats["warm_admissions"] != 3 or \
            pstats["prefix_hit_chunks"] != 3 * n_shared:
        fails.append(f"serve: not 3 warm admissions of {n_shared} chunks: "
                     f"{pstats}")
    if check["private_adopted"] or not check["shared_resident"]:
        fails.append(f"serve: shared chunks not in one pool slot: {check}")
    if scat["repeated"] or not scat["with_arena"]:
        fails.append(f"serve: slab updates {scat}")
    zero = [k for k, v in launches.items() if v <= 0]
    if zero:
        fails.append(f"serve: path never launched {zero}")
    res["leaks"] = _prefix_leaks(eng)
    if res["leaks"]:
        fails.append(f"serve leaked {res['leaks']}")
    st.close()
    del eng, st, decode_round, checked_round
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res, fails


def phase_prefix(np, torch, cfg, params, tag="[prefix]"):
    """Phase 4j: the shared-prefix cache at full width (see the module
    docstring); phase 4k runs it on the MLA model at full depth."""
    t_phase = time.perf_counter()
    prompts = prefix_prompts(np, cfg)
    sa, fa, la, ia, rows = _prefix_pair_run(np, torch, cfg, params, prompts,
                                            True, None)
    sb, fb, lb, ib, _ = _prefix_pair_run(np, torch, cfg, params, prompts,
                                         False, rows)
    del rows
    gc.collect()
    same = sa == sb
    first_bitwise = fa.keys() == fb.keys() and all(
        np.array_equal(fa[k], fb[k]) for k in fa)
    rounds_bitwise = len(la) == len(lb) and all(
        np.array_equal(a, b) for a, b in zip(la, lb))
    diff = max([float(np.abs(a - b).max()) for a, b in zip(la, lb)]
               + [float(np.abs(fa[k] - fb[k]).max()) for k in fa if k in fb],
               default=None)
    n_shared = PREFIX_TOKENS // cfg.leoam.chunk_size
    layers = cfg.n_layers
    cb, ab = ia["chunk_bytes"], ia["abstract_bytes"]
    per_cow = layers * cb
    fails = []
    if not (same and first_bitwise and rounds_bitwise):
        fails.append(f"warm/cold pair differs (streams equal {same}, first "
                     f"logits bitwise {first_bitwise}, rounds bitwise "
                     f"{rounds_bitwise}, max logit diff {diff!r})")
    if not ib["rows_bitwise"]:
        fails.append("the adopter's arena replica rows differ from the cold "
                     "engine's private rows")
    if len(ia["adopter_rows"]) != 1 or ia["adopter_rows"][0] < 2:
        fails.append(f"the adopter's prefix is not in one arena row: "
                     f"{ia['adopter_rows']}")
    if ia["prefix_ref_ops"] != n_shared or ia["prefix_ref_bytes"] != 0.0:
        fails.append(f"prefix_ref {ia['prefix_ref_ops']} ops, "
                     f"{ia['prefix_ref_bytes']} B (want {n_shared}, 0)")
    want_dedup = n_shared * layers * (cb + ab)
    if ia["prefix_stats"]["bytes_deduped"] != want_dedup:
        fails.append(f"bytes_deduped {ia['prefix_stats']['bytes_deduped']} "
                     f"!= {want_dedup}")
    n_cow = ia["cow_copies"]
    if not (n_cow == 2 and ia["cow_read"] == [n_cow * layers, n_cow * per_cow]
            and ia["cow_copy"] == ia["cow_read"]):
        fails.append(f"COW billing {n_cow} copies, cow_read {ia['cow_read']},"
                     f" cow_copy {ia['cow_copy']} (want 2 of {per_cow} B)")
    for name, info in (("cache on", ia), ("cache off", ib)):
        lc = info["launches"]
        if any(lc[k] <= 0 for k in _path_kernels(cfg)):
            fails.append(f"{name}: B1/B2 not launched: {lc}")
        if info["leaks"]:
            fails.append(f"{name} leaked {info['leaks']}")
    serve, serve_fails = _prefix_serve(np, torch, cfg, params, prompts)
    fails += serve_fails
    launches = {k: ia["launches"][k] + ib["launches"][k]
                + serve["launches"][k] for k in serve["launches"]}
    row = {"prompts": [len(p) for p in prompts],
           "shared_tokens": PREFIX_TOKENS,
           "prefill_chunk_tokens": PREFIX_CHUNK_TOKENS,
           "pair": {"new_tokens": FAULT_NEW_TOKENS, "streams_identical": same,
                    "first_logits_bitwise": first_bitwise,
                    "round_logits_bitwise": rounds_bitwise,
                    "max_logit_diff": diff,
                    "adopter_rows_bitwise": ib["rows_bitwise"],
                    "admit_s_warm": ia["admit_s"], "admit_s_cold": ib["admit_s"],
                    "resident_slots_with_cache": ia["resident_slots"],
                    "resident_slots_without": ib["resident_slots"],
                    "pool_slots_saved": ib["resident_slots"]
                    - ia["resident_slots"],
                    **{k: ia[k] for k in (
                        "prefix_ref_ops", "prefix_ref_bytes", "cow_copies",
                        "cow_read", "cow_copy", "prefix_stats",
                        "fidelity_bytes", "hit_tokens", "adopter_rows")},
                    "launches_on": ia["launches"],
                    "launches_off": ib["launches"]},
           "serve": serve, "launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    print(f"{tag} {json.dumps(row)}")
    if fails:
        raise SystemExit(f"chip_smoke: {tag} " + "; ".join(fails))
    return row


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def phase_e2e(np, torch, cfg, params, tag="[e2e]", check=None,
              bar=None):
    """First request's prefill + 2 decode rounds: kernels vs plain.  The
    plain run goes first and records each layer's chunk selection (and an
    MoE model's expert choices); the kernel run replays them (B1 still
    runs), so only the kernels' arithmetic differs and a near-tied chunk
    or expert choice cannot flip.  With a ``check`` dict, every kernel
    call of the kernel run's first round is held against its plain
    version on the same inputs (:func:`_check_engine_kernels`).  The
    logits are held to ``TOL_E2E_ULPS`` bf16 ulps of max|logit|, or to
    the absolute ``bar`` when one is given."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg

    prompt = np.random.RandomState(0).randint(2, cfg.vocab_size, PROMPTS[0])
    out, recorded, flips = {}, [], [0, 0]
    routes, route_flips = [], []
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
        if cfg.moe is None:
            spy = contextlib.nullcontext()
        elif impl == "ref":
            spy = _moe_routes(torch, record=routes)
        else:
            spy = _moe_routes(torch, replay=routes, flips=route_flips)
        with spy:
            sid, tok = eng.add_sequence(prompt)
            logits = [eng.last_logits.copy()]
            toks = {sid: tok}
            for r in range(2):
                with (_check_engine_kernels(check)
                      if check is not None and impl is None and r == 0
                      else contextlib.nullcontext()):
                    toks = eng.decode_round(toks)
                logits.append(eng.last_logits[0].copy())
        out[impl] = logits
        eng.store.close()
        del eng, select, select_fn     # the patch closes a reference cycle
        gc.collect()
        torch.cuda.empty_cache()
    diffs = [float(np.abs(a - b).max()) for a, b in zip(out[None], out["ref"])]
    ulps = [TOL_E2E_ULPS * _bf16_ulp(float(np.abs(b).max()))
            for b in out["ref"]]
    bars = ulps if bar is None else [bar] * len(ulps)
    differ = [float((a != b).mean()) for a, b in zip(out[None], out["ref"])]
    same = [int(np.argmax(a)) == int(np.argmax(b))
            for a, b in zip(out[None], out["ref"])]
    print(f"{tag} max |logit(kernels) - logit(plain)| prefill, round 1, "
          f"round 2: {diffs!r} (tol {bars!r}; {TOL_E2E_ULPS} bf16 ulps of "
          f"max|logit|: {ulps!r}); fraction of logits that differ "
          f"{differ!r}; layers "
          f"whose own chunk selection would differ, per round: {flips} "
          f"(replayed); same argmax {same}"
          + (f"; token rows whose own experts would differ: "
             f"{sum(route_flips)} of {len(route_flips)} MoE calls "
             f"(replayed)" if cfg.moe is not None else ""))
    if not all(d <= b for d, b in zip(diffs, bars)):
        raise SystemExit(f"chip_smoke: {tag} end-to-end logits disagree")
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


def run_phases(np, torch, names):
    """``--phases``: the named engine phases alone, with their gates
    (longchat is built only for the phases that serve it, and freed
    before 4k)."""
    cfg = params = None
    if names - set(OWN_MODEL_PHASES):
        cfg, params = init_longchat(torch)
    runners = {
        "4c": lambda: phase_admission(np, torch,
                                      *cut_for("4c", cfg, params)),
        "4d": lambda: _serve_modes(np, torch, cfg, params),
        "4e": lambda: _serve_sidecar(np, torch, cfg, params),
        "4f": lambda: phase_legacy(np, torch, *cut_for("4f", cfg, params)),
        "4g": lambda: phase_reopen(np, torch),
        "4h": lambda: phase_faults(np, torch, *cut_for("4h", cfg, params)),
        "4i": lambda: phase_preempt(np, torch, *cut_for("4i", cfg, params)),
        "4j": lambda: phase_prefix(np, torch, *cut_for("4j", cfg, params)),
        "4o": lambda: phase_profile(np, torch, *cut_for("4o", cfg, params)),
        "4l": lambda: phase_decode_step(np, torch, cfg, params),
        "4k": lambda: phase_mla(np, torch),
        "4m": lambda: phase_a11(np, torch),
        "4n": lambda: phase_train(np, torch),
        "4p": lambda: phase_mesh(np, torch),
        "4q": lambda: phase_dryrun(np, torch)}
    try:
        for name in ENGINE_PHASES:
            if name in names:
                if name in OWN_MODEL_PHASES:
                    params = None              # longchat leaves the card
                    gc.collect()
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                runners[name]()
                print(f"[time] phase {name} {time.perf_counter() - t0!r} s")
    finally:
        shutil.rmtree(KV_ROOT, ignore_errors=True)
    print(f"[time] chip_smoke {time.perf_counter() - T_START!r} s")
    return 0


def main() -> int:
    if TRAIN_CHILD_FLAG in sys.argv[1:]:
        return train_resume_child(MESH_TRAIN_ONLY_FLAG in sys.argv[1:])
    if DRYRUN_CHILD_FLAG in sys.argv[1:]:
        return dryrun_child(int(sys.argv[sys.argv.index(
            DRYRUN_CHILD_FLAG) + 1]))
    only = only_kernels(sys.argv[1:])
    phases = only_phases(sys.argv[1:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import build

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
        if "latent" in only:
            from repro_torch.configs import get_config
            mla_cfg = get_config(MLA_ARCH)
            print_row("chunk_bounds_latent",
                      b1_latent_row(torch, mla_cfg, flush))
            print_row("sparse_decode_latent",
                      b2_latent_row(np, torch, mla_cfg, flush))
        return 0
    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            print(f"[time] phase {name} {time.perf_counter() - t0!r} s")

    if not phases:
        rows, long_row, clustered, b3_48 = timed("3", phase_kernels, np,
                                                 torch, rng)
        mla_rows = timed("3 (latent)", mla_kernel_rows, np, torch)
        pq_train_res = timed("3b", phase_pq_train, np, torch)

    if phases:
        return run_phases(np, torch, phases)
    cfg, params = init_longchat(torch)
    try:
        serve = timed("4", phase_serve, np, torch, cfg, params)
        serve_pq = timed("4b", phase_serve, np, torch,
                         *cut_for("4b", cfg, params), pq=True)
        admission = timed("4c", phase_admission, np, torch,
                          *cut_for("4c", cfg, params))
        serve_async, serve_chunked = timed("4d", _serve_modes, np, torch,
                                           cfg, params)
        serve_sidecar = timed("4e", _serve_sidecar, np, torch, cfg, params)
        print(f"[serve-sidecar] disk->host kv ({SERVE_MODES_LAYERS} of "
              f"{cfg.n_layers} layers) beside phase 4's: "
              f"{json.dumps(serve_sidecar['disk_kv'])} against "
              f"{json.dumps(serve['disk_kv'])}")
        legacy = timed("4f", phase_legacy, np, torch,
                       *cut_for("4f", cfg, params))
        reopen = timed("4g", phase_reopen, np, torch)
        faults = timed("4h", phase_faults, np, torch,
                       *cut_for("4h", cfg, params))
        preempt = timed("4i", phase_preempt, np, torch,
                        *cut_for("4i", cfg, params))
        prefix = timed("4j", phase_prefix, np, torch,
                       *cut_for("4j", cfg, params))
        profile = timed("4o", phase_profile, np, torch,
                        *cut_for("4o", cfg, params))
        e2e = timed("5", phase_e2e, np, torch, cfg, params)
        decode = timed("4l", phase_decode_step, np, torch, cfg, params)
        # phase 4k: longchat's weights leave the card first
        del params
        gc.collect()
        torch.cuda.empty_cache()
        mla = timed("4k", phase_mla, np, torch, mla_rows)
        a11 = timed("4m", phase_a11, np, torch)
        train = timed("4n", phase_train, np, torch)
        mesh = timed("4p", phase_mesh, np, torch)
        dry = timed("4q", phase_dryrun, np, torch, 1)
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
        # the latent variants replace jnp functions, not Pallas kernels
        "chunk_bounds_latent": (src + "chunk_bounds_latent.cu",
                                "src/repro/core/bounds.py:62"),
        "sparse_decode_latent": (src + "sparse_decode_latent.cu",
                                 "src/repro/serving/engine.py:341"),
    }
    # launches: B1-B3 from the minmax serve plus phase 4j's three runs (the
    # shared-prefix path), B1/B2 also from phase 4l (lm.decode_step), B4/B5
    # from the PQ serve (the path that runs them); each path's counts were
    # zeroed just before it.  B3 also from phase 4k's serve, the latent
    # variants from it alone
    mla_l = mla["serve"]["launches"]
    launches = {**{k: serve["launches"][k] + prefix["launches"][k]
                   + decode["launches"].get(k, 0)
                   for k in prefix["launches"]},
                "pq_assign": serve_pq["launches"]["pq_assign"],
                "pq_update": serve_pq["launches"]["pq_update"],
                "chunk_bounds_latent": mla_l["chunk_bounds_latent"],
                "sparse_decode_latent": mla_l["sparse_decode_latent"]}
    launches["kv_dequant"] += mla_l["kv_dequant"]
    # B1-B3 also from phase 4m's paths (jamba's and qwen2-vl's serves,
    # qwen2-vl's and seamless's decode_step runs) and phase 4o's profiled
    # serve
    for k in ("chunk_bounds", "sparse_decode", "kv_dequant"):
        launches[k] += a11["launches"].get(k, 0)
        launches[k] += profile["launches"]["b"].get(k, 0)
    # B1 and B2 also from phase 4p's sharded decodes, every rank's count,
    # and from phase 4q's measured decode steps
    for k in ("chunk_bounds", "sparse_decode"):
        launches[k] += mesh["launches"][k] + dry["launches"][k]
    kernels = []
    for name, r in {**rows, **mla["rows"]}.items():
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": max(r["bound"]) * 1e3,
            "bound_by": "bytes" if r["bound"][0] >= r["bound"][1]
            else "operations",
            "library_ms": r["library_ms"],
            "cuda_per_call": _n_cuda_kernels(r),
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
                      "preempt": preempt, "prefix": prefix,
                      "profile": profile, "decode_step": decode,
                      "pq_train": pq_train_res,
                      "sparse_decode_32k": long_b2,
                      "pq_update_clustered": b5_clustered,
                      "kv_dequant_48": b3_48c,
                      "mla": {k: v for k, v in mla.items()
                              if k != "rows"},
                      "a11": a11, "train": train, "mesh": mesh,
                      "dryrun": dry}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# Phase 4l: the in-model sparse decode (lm.decode_step) on longchat
# ---------------------------------------------------------------------------


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone()


def _same_input_flips(torch, cfg, cache):
    """For each layer of a decode ``cache``: ``pyramid_select_gqa`` with
    B1 and with its plain version on one seeded q (bf16, scaled as the
    model scales it) — the layers whose two selections differ as sets."""
    from repro_torch.core.adaptive import pyramid_select_gqa
    from repro_torch.models import attention as attn
    from repro_torch.models import lm
    dev = cache["prologue"][0]["k"].device
    g = torch.Generator(device=dev).manual_seed(DECODE_SEED)
    chunk, out = cfg.leoam.chunk_size, []
    _, period, repeats = lm._layer_plan(cfg)
    layers = list(cache["prologue"]) + [
        {k: v[r] for k, v in cache["body"][pi].items()}
        for r in range(repeats) for pi in range(len(period))]
    for i, c in enumerate(layers):
        B = c["k"].shape[0]
        q = (torch.randn(B, cfg.n_heads, cfg.hd, device=dev, generator=g)
             / math.sqrt(cfg.hd)).bfloat16()
        pyr = attn._pyr_from_cache(c)
        budget = attn._layer_budget(cfg, i if i < len(cache["prologue"])
                                    else 10 ** 6, pyr.base_chunks)
        nv = (DECODE_PROMPT + DECODE_STEPS + chunk) // chunk
        a = pyramid_select_gqa(q, pyr, budget, n_valid0=nv)
        b = pyramid_select_gqa(q, pyr, budget, n_valid0=nv, impl="ref")
        out.append(int(not torch.equal(a.sort(-1).values,
                                       b.sort(-1).values)))
    return sum(out), len(out)


def phase_decode_step(np, torch, cfg, params):
    """Phase 4l: ``lm.decode_step``, the in-model LeoAM sparse decode, at
    full width and depth: ``DECODE_BATCH`` prompts of ``DECODE_PROMPT``
    tokens prefilled into a ``MAX_LEN`` cache (its abstract pyramid: 64,
    32 and 16 nodes a layer), then ``DECODE_STEPS`` steps twice from the
    same cache — the plain versions (``impl="ref"``) first, recording each
    layer's chunk selection, then kernels B1 and B2, replaying those
    selections and fed the plain run's tokens.  In the kernel run's first
    step every kernel call is followed by its plain version on the same
    inputs (``repro_torch.testing.check_decode_kernels``).  Gates: each
    such call within its bar (B1 ``TOL_BOUNDS_REL`` and finite on the
    pyramid's sentinel boxes, B2 ``contract_agreement``'s bf16 bar), the
    descent with B1 and with its plain version on one input per layer
    picking the same chunks in every layer, every step's logits within
    ``TOL_E2E_ULPS`` bf16 ulps of max|logit| of the plain run's, the first
    token the same, B2 launched once per layer and step and B1 at least
    as often.  Prints the step time (median, min and max of the steps
    after the checked one), the peak device memory and the
    sparse-against-dense cosine of the first step's logits."""
    import dataclasses
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.models import lm
    from repro_torch.core.abstracts import build_pyramid
    from repro_torch.testing import check_decode_kernels, replay_selections

    t_phase = time.perf_counter()
    S, B, n = DECODE_PROMPT, DECODE_BATCH, DECODE_STEPS
    rng = np.random.RandomState(DECODE_SEED)
    prompts = torch.from_numpy(rng.randint(2, cfg.vocab_size, (B, S))).cuda()
    torch.cuda.reset_peak_memory_stats()
    dense = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, min_seq_for_sparse=10 ** 9))
    with torch.no_grad():
        t0 = time.perf_counter()
        logits0, cache = lm.prefill(params, cfg, {"tokens": prompts},
                                    max_len=MAX_LEN)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        # the abstract pyramid that every prefill builds now (an engine
        # admission too, which never reads it): one layer's, at this batch,
        # wall time a call with the device synchronized (median of 5)
        pyr_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_pyramid(cache["prologue"][0]["k"], cfg.leoam.chunk_size,
                          cfg.leoam.pyramid_levels, length=S)
            torch.cuda.synchronize()
            pyr_s.append(time.perf_counter() - t0)
        kcache = _clone_tree(cache)
        levels = sum(k.startswith("kmax") for k in cache["prologue"][0])
        tokens = [logits0.argmax(-1)]
        sels, ref_logits, ref_s = [], [], []
        with replay_selections(record=sels):
            for step in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = lm.decode_step(params, cfg, cache,
                                           {"token": tokens[-1]}, S + step,
                                           impl="ref")
                torch.cuda.synchronize()
                ref_s.append(time.perf_counter() - t0)
                ref_logits.append(lg.float().cpu().numpy())
                tokens.append(lg.argmax(-1))
        del cache
        gc.collect()
        # dense decode of the first step (writes the row the sparse step
        # writes again, leaves the pyramid alone)
        dense_logits, _ = lm.decode_step(params, dense, kcache,
                                         {"token": tokens[0]}, S)
        dense_logits = dense_logits.float().cpu().numpy()
        pairs, out, kern_s, checks = [], [], [], {}
        cb.launches = sd.launches = 0
        with replay_selections(replay=sels, pairs=pairs):
            for step in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (check_decode_kernels(checks) if step == 0
                      else contextlib.nullcontext()):
                    lg, kcache = lm.decode_step(params, cfg, kcache,
                                                {"token": tokens[step]},
                                                S + step)
                torch.cuda.synchronize()
                kern_s.append(time.perf_counter() - t0)
                out.append(lg.float().cpu().numpy())
        launches = {"chunk_bounds": cb.launches, "sparse_decode": sd.launches}
        # a layer step whose own selection picked other chunks, and one
        # that picked the same chunks in another order (B2 adds in the
        # order of the ids)
        flips = [int(not torch.equal(a.sort(-1).values, b.sort(-1).values))
                 for a, b in pairs]
        reordered = [int(not torch.equal(a, b)) for a, b in pairs]
        L = cfg.n_layers
        flips_by_layer = [sum(flips[i::L]) for i in range(L)]
        # the descent with B1 and with its plain version on one input per
        # layer (a seeded q, the cache's own pyramid): whether B1's sums
        # alone move a selection, or only the drift of q between the runs
        same_input_flips = _same_input_flips(torch, cfg, kcache)
        # one more step under torch.profiler: CUDA kernels a step launches
        # and the device time they take (busy share of the step's wall)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                            device=logits0.device)
        try:
            kernels = _cuda_kernels_per_call(
                torch, lambda: lm.decode_step(params, cfg, kcache,
                                              {"token": tokens[n]}, S + n),
                flush, reps=1)
            profile = {"cuda_kernels": len(kernels),
                       "device_busy_ms": sum(e - b for _, b, e in kernels)
                       / 1e3,
                       "device_span_ms": kernels[-1][2] / 1e3}
        except SystemExit as e:
            profile = {"not_measured": str(e)[:200]}
        del flush
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del kcache, pairs, sels
    gc.collect()
    torch.cuda.empty_cache()
    diffs = [float(np.abs(a - b).max()) for a, b in zip(out, ref_logits)]
    bars = [TOL_E2E_ULPS * _bf16_ulp(float(np.abs(b).max()))
            for b in ref_logits]
    same = [int(a.argmax(-1)[i]) == int(b.argmax(-1)[i])
            for a, b in zip(out, ref_logits) for i in range(B)]
    a, b = out[0].astype(np.float64), dense_logits.astype(np.float64)
    cos = [float(a[i] @ b[i] / (np.linalg.norm(a[i]) * np.linalg.norm(b[i])))
           for i in range(B)]
    n_layers = cfg.n_layers
    # each kernel call of the checked step against its plain version
    kernel_checks = _summarize_checks(checks)
    if "sparse_decode" in checks:
        kernel_checks["sparse_decode"]["max_triple_rel_err"] = max(
            r["triple_rel_err"] for r in checks["sparse_decode"])
    timed = kern_s[1:]          # the first step also ran the checks
    row = {"batch": B, "prompt": S, "max_len": MAX_LEN, "steps": n,
           "pyramid_levels": levels, "prefill_s": prefill_s,
           "pyramid_build_ms_per_layer": float(np.median(pyr_s)) * 1e3,
           "median_step_s": float(np.median(timed)),
           "min_step_s": min(timed), "max_step_s": max(timed),
           "median_step_plain_s": float(np.median(ref_s)),
           "checked_first_step_s": kern_s[0], "peak_device_gib": peak,
           "kernel_checks": kernel_checks,
           "max_logit_diff": diffs, "bars": bars,
           "argmax_agree": f"{sum(same)} of {len(same)}",
           "first_token_same": same[:B],
           "selection_flips": f"{sum(flips)} of {len(flips)} layer steps "
           f"(replayed)",
           "selection_reordered": f"{sum(reordered)} of {len(reordered)}",
           "selection_flips_by_layer": flips_by_layer,
           "same_input_flips": f"{same_input_flips[0]} of "
           f"{same_input_flips[1]} layers", "step_profile": profile,
           "sparse_vs_dense_cos": cos, "launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    print(f"[decode-step] {json.dumps(row)}")
    fails = []
    if not all(d <= t for d, t in zip(diffs, bars)):
        fails.append(f"logits off the plain run's by {diffs} (bars {bars})")
    if not all(same[:B]):
        fails.append(f"first token differs: {same[:B]}")
    if launches["sparse_decode"] != n * n_layers or \
            launches["chunk_bounds"] < n * n_layers:
        fails.append(f"launches {launches} (B2 {n * n_layers} wanted, B1 "
                     f"at least as many)")
    if not all(np.isfinite(x).all() for x in out):
        fails.append("non-finite logits")
    if set(kernel_checks) != {"chunk_bounds", "chunk_bounds_gqa",
                              "sparse_decode"} or \
            kernel_checks["sparse_decode"]["calls"] != n_layers or \
            not all(c["all_ok"] for c in kernel_checks.values()):
        fails.append(f"kernel calls against their plain versions: "
                     f"{kernel_checks}")
    if same_input_flips[0]:
        fails.append(f"B1 moved the selection of {same_input_flips[0]} of "
                     f"{same_input_flips[1]} layers on one input")
    if fails:
        raise SystemExit("chip_smoke: [decode-step] " + "; ".join(fails))
    return row


# ---------------------------------------------------------------------------
# Phase 4k: the MLA latent path with no-drop MoE (deepseek-v2-lite-16b)
# ---------------------------------------------------------------------------


def _latent_selections(np, rng, lengths, chunk=64, rate=0.10):
    """Each sequence's chunk selection as b2_row draws it (the tree at
    ``rate``, chunk 0, the last two, 5 % of MAX_LEN's chunks hot)."""
    from repro_torch.core.adaptive import tree_select_chunks
    sels = []
    for L in lengths:
        nv = -(-int(L) // chunk)
        sel, _ = tree_select_chunks(rng.rand(nv), int(L),
                                    max(chunk, math.ceil(L * rate)), chunk)
        hot = rng.choice(nv, max(1, int(MAX_LEN // chunk * 0.05)),
                         replace=False)
        sels.append(sorted(set(sel) | {0} | {nv - 2, nv - 1}
                           | {int(c) for c in hot}))
    return sels


def b1_latent_row(torch, cfg, flush):
    """B1's latent variant at the MLA evaluate stage's shape: q (B, 16,
    576) bf16 against (B, nc, 1, 576) f32 latent boxes of the serve's
    lengths halfway through decode."""
    from repro_torch.kernels.chunk_bounds import ops as cb
    dev = torch.device("cuda")
    m = cfg.mla
    B, H, D, chunk = len(PROMPTS), cfg.n_heads, \
        m.kv_lora_rank + m.qk_rope_head_dim, 64
    nc = max(-(-int(L) // chunk) for L in MAIN_LENGTHS)
    g = torch.Generator(device=dev).manual_seed(2)
    q = (torch.randn(B, H, D, device=dev, generator=g)
         / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)).bfloat16()
    km = torch.randn(B, nc, 1, D, device=dev, generator=g)
    kn = km - torch.randn(B, nc, 1, D, device=dev, generator=g).abs()
    ub_k, lb_k = cb.chunk_bounds_latent(q, km, kn)
    ub_r, lb_r = cb.chunk_bounds_latent(q, km, kn, impl="ref")
    err = max((ub_k - ub_r).abs().max().item(),
              (lb_k - lb_r).abs().max().item())
    tol = TOL_BOUNDS_REL * max(ub_r.abs().max().item(),
                               lb_r.abs().max().item())
    qf = q.float()
    qp, qn = qf.clamp(min=0), qf.clamp(max=0)
    kmt, knt = km[:, :, 0], kn[:, :, 0]
    nbytes = _nbytes(q, km, kn, ub_r, lb_r)
    ops = 8 * B * H * nc * D
    return dict(
        max_abs_err=err, tol=tol,
        ms=_time_ms(lambda: cb.chunk_bounds_latent(q, km, kn), flush),
        plain_ms=_time_ms(
            lambda: cb.chunk_bounds_latent(q, km, kn, impl="ref"), flush),
        library_ms=_time_ms(lambda: torch.einsum("bhd,bcd->bc", qp, kmt)
                            + torch.einsum("bhd,bcd->bc", qn, knt), flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: cb.chunk_bounds_latent(q, km, kn), flush),
        bound=(nbytes / HBM_BYTES_S, ops / PEAK_F32),
        shape=f"q {tuple(q.shape)} bf16, latent boxes {tuple(km.shape)} f32")


def b2_latent_row(np, torch, cfg, flush):
    """B2's latent variant at the MLA serve's shape: 4 sequences of
    MAIN_LENGTHS, the selection b2_row draws, a one-plane fp16 pool of
    every chunk, q = concat(q_lat, q_rope) (4, 16, 576) bf16 pre-scaled
    and the round's latent rows; against its plain version (the bar of
    ``latent_agreement``: two probabilities rounded the other way), two
    launches bitwise equal."""
    import torch.nn.functional as F
    from repro_torch.kernels.sparse_decode import ops as sd
    from repro_torch.kernels.sparse_decode.ref import (latent_agreement,
                                                       latent_pooled_den)

    dev = torch.device("cuda")
    rng = np.random.RandomState(20)
    m = cfg.mla
    B, H, chunk = len(PROMPTS), cfg.n_heads, 64
    r, D = m.kv_lora_rank, m.kv_lora_rank + m.qk_rope_head_dim
    lengths = np.array(MAIN_LENGTHS, np.int32)
    sels = _latent_selections(np, rng, lengths)
    nmax = -(-max(len(x) for x in sels) // 4) * 4
    n_slots = B * (MAX_LEN // chunk)
    pool = torch.randn(n_slots + 1, 1, chunk, 1, D,
                       device=dev).to(torch.float16)
    slots = np.zeros((B, nmax), np.int32)
    cids = np.full((B, nmax), -1, np.int32)
    for b, x in enumerate(sels):
        slots[b, :len(x)] = rng.choice(n_slots, len(x), replace=False)
        cids[b, :len(x)] = x
    slots_t = torch.from_numpy(slots).to(dev)
    cids_t = torch.from_numpy(cids).to(dev)
    len_t = torch.from_numpy(lengths).to(dev)
    q = (torch.randn(B, H, D, device=dev)
         / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)).bfloat16()
    lat_new = torch.randn(B, D, device=dev).bfloat16()
    args = (q, pool, slots_t, cids_t, len_t, lat_new, r)
    o_k = sd.sparse_decode_latent_pooled(*args)
    o_k2 = sd.sparse_decode_latent_pooled(*args)
    o_r = sd.sparse_decode_latent_pooled(*args, impl="ref")
    err, tol = latent_agreement(o_k, o_r, (pool, lat_new),
                                latent_pooled_den(*args))
    pos = (cids_t.long()[..., None] * chunk
           + torch.arange(chunk, device=dev)).reshape(B, -1)
    ok = (cids_t[..., None] >= 0).expand(B, nmax, chunk).reshape(B, -1) \
        & (pos < len_t[:, None])
    bias = torch.zeros(B, 1, nmax * chunk + 1, device=dev)
    bias[:, 0, :-1].masked_fill_(~ok, float("-inf"))
    bias = bias.expand(B, H, -1)

    def library():
        lat = pool[slots_t.long()][:, :, 0].reshape(B, -1, D)
        lat = torch.cat([lat, lat_new[:, None].half()], 1).float()
        s = torch.baddbmm(bias, q.float(), lat.transpose(1, 2))
        return torch.bmm(F.softmax(s, dim=-1), lat[..., :r])

    live_rows = sum(min(chunk, int(L) - c * chunk) for L, x in
                    zip(lengths, sels) for c in x)
    nbytes = (live_rows * D * 2 + _nbytes(q, lat_new, o_r)
              + _nbytes(slots_t, cids_t, len_t))
    # scores: bf16 q x fp16 row, both exact in TF32; P.V: fp16 p x fp16
    # row with f32 sums, the fp16 tensor-core type
    ops_s, ops_pv = (2 * H * w * (live_rows + B) for w in (D, r))
    row = dict(
        max_abs_err=err, tol=tol, bitwise=bool(torch.equal(o_k, o_k2)),
        ms=_time_ms(lambda: sd.sparse_decode_latent_pooled(*args), flush),
        plain_ms=_time_ms(
            lambda: sd.sparse_decode_latent_pooled(*args, impl="ref"), flush),
        library_ms=_time_ms(library, flush),
        cuda_per_call=_cuda_kernels_per_call(
            torch, lambda: sd.sparse_decode_latent_pooled(*args), flush),
        bound=(nbytes / HBM_BYTES_S,
               ops_s / PEAK_TF32 + ops_pv / PEAK_BF16),
        shape=f"B={B} lengths={list(map(int, lengths))} nmax={nmax} live "
              f"chunks={int((cids >= 0).sum())} live rows={live_rows} "
              f"chunk={chunk} H={H} D={D} r={r} one fp16 plane, bf16 q")
    del pool
    torch.cuda.empty_cache()
    return row


def mla_kernel_rows(np, torch):
    """B1-latent, B2-latent and B3 into one latent plane against their
    plain versions at phase 4k's shapes (the model's widths, no weights):
    run in phase 3, beside the other kernels' rows, or by ``--phases 4k``
    alone.  Returns ({name: row}, B3's row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sparse_decode.ref import LATENT_FLIPS

    cfg = get_config(MLA_ARCH)
    m = cfg.mla
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = {"chunk_bounds_latent": b1_latent_row(torch, cfg, flush),
            "sparse_decode_latent": b2_latent_row(np, torch, cfg, flush)}
    slab = torch.zeros(len(PROMPTS) * (MAX_LEN // 64) + 1, 1, 64, 1,
                       m.kv_lora_rank + m.qk_rope_head_dim,
                       dtype=torch.float16, device="cuda")
    b3_lat = b3_row(np, torch, flush, slab, 16)
    del slab, flush
    torch.cuda.empty_cache()
    for name, r in rows.items():
        print_row(name, r)
    print_row("kv_dequant on one latent plane", b3_lat)
    print(f"[kernel] sparse_decode_latent tol: {LATENT_FLIPS} probabilities "
          f"rounded the other way, 2^-11 x max|row| / min den each; "
          f"chunk_bounds_latent tol: {TOL_BOUNDS_REL} of max|bound|")
    bad = [n for n, r in {**rows, "kv_dequant on one plane": b3_lat}.items()
           if not r["max_abs_err"] <= r["tol"] or not r.get("bitwise", True)
           or not r.get("exact", True)]
    # B1-latent is one CUDA kernel a call, B2-latent two (scores, then P.V
    # with the combine)
    bad += [n for n, want in LATENT_CUDA_PER_CALL.items()
            if _n_cuda_kernels(rows[n]) != want]
    if bad:
        raise SystemExit(f"chip_smoke: latent kernels disagree with their "
                         f"plain versions (or two launches differ, or a "
                         f"call launches other CUDA kernels than "
                         f"{LATENT_CUDA_PER_CALL}): {bad}")
    return rows, b3_lat


def phase_mla(np, torch, kernel_rows=None):
    """Phase 4k: deepseek-v2-lite-16b at full width through the latent
    path: the serve, admission parity, legacy against pooled and end to
    end, each gated as its longchat phase is.  ``kernel_rows`` are
    :func:`mla_kernel_rows`' (measured in phase 3), else measured here."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    rows, b3_lat = kernel_rows or mla_kernel_rows(np, torch)
    cfg = get_config(MLA_ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    m = cfg.mla
    print(f"[init] {MLA_ARCH} full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA {m.kv_lora_rank} + "
          f"{m.qk_rope_head_dim}, {cfg.moe.n_experts} experts top-"
          f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, {cfg.dtype}, "
          f"{n_params / 1e9!r} G params in {time.perf_counter() - t0!r} s, "
          f"{torch.cuda.memory_allocated() / 2**30!r} GiB on the card")
    torch.cuda.reset_peak_memory_stats()
    # the opt-in planes, the fault run and admission parity at
    # MLA_CUT_LAYERS of the 27 layers: the serve, legacy and end to end
    # stay at full depth
    cut, cut_params = cut_depth(cfg, params, MLA_CUT_LAYERS)
    print(f"[depth] phase 4k (serve-pq-mla, prefix-mla, serve-sidecar-mla, "
          f"faults-mla, admit-mla): {MLA_CUT_LAYERS} of {cfg.n_layers} "
          f"layers (the dense layer and the first MoE layers), full width")
    try:
        serve = phase_serve(np, torch, cfg, params, tag="[serve-mla]")
        serve_pq = phase_serve(np, torch, cut, cut_params, pq=True,
                               tag="[serve-pq-mla]")
        # the PQ streams are printed, not gated (ROADMAP C12: the requant
        # sweep races the next round's code reads)
        print(f"[serve-pq-mla] streams {json.dumps(serve_pq['streams'])} "
              f"against min/max {json.dumps(serve['streams'])}")
        prefix = phase_prefix(np, torch, cut, cut_params,
                              tag="[prefix-mla]")
        sidecar = phase_serve(np, torch, cut, cut_params, sidecar=True,
                              tag="[serve-sidecar-mla]")
        faults = _mla_faults(np, torch, cut, cut_params)
        admission = phase_admission(np, torch, cut, cut_params,
                                    tag="[admit-mla]", serial=False,
                                    chunk_tokens=MLA_CHUNK_TOKENS)
        legacy = phase_legacy(np, torch, cfg, params,
                              tag="[serve-legacy-mla]")
        e2e = phase_e2e(np, torch, cfg, params, tag="[e2e-mla]")
    finally:
        del params, cut_params
        gc.collect()
        torch.cuda.empty_cache()
    b3c = {k: v for k, v in b3_lat.items() if k != "bound"}
    b3c["bound_ms"] = max(b3_lat["bound"]) * 1e3
    return {"rows": rows, "serve": serve, "serve_pq": serve_pq,
            "prefix": prefix, "serve_sidecar": sidecar, "faults": faults,
            "admission": admission, "legacy": legacy, "e2e_max_diff": e2e,
            "kv_dequant_one_plane": b3c,
            "init": {"params": n_params}}


def _mla_faults(np, torch, cfg, params):
    """Phase 4k's fault run, with the sync sanitizer on
    (``debug_sync=True``): the 1536- and 2048-token prompts admitted
    chunked with the sidecar and the real codec under ``MLA_FAULT_PLAN``,
    ``FAULT_NEW_TOKENS`` tokens each.  Gates: ``io_retries`` >= 1,
    ``checksum_failures`` >= 2, ``chunks_recomputed`` >= 1, no failed
    sequence, the store's locks tracked, nothing leaked, B1-/B2-latent and
    B3 launched."""
    from repro_torch.serving import sanitizer
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.faults import FaultPlan

    prompts = serve_prompts(np, cfg)[:2]
    plan = FaultPlan(schedule={k: dict(v) for k, v in
                               MLA_FAULT_PLAN.items()})
    root = KV_ROOT / "faults_mla"
    eng = BatchedLeoAMEngine(
        cfg, params,
        EngineCfg(max_len=MAX_LEN, real_codec=True, pipeline=False,
                  disk_sidecar=True, cpu_chunk_frac=FAULT_CPU_FRAC,
                  fault_plan=plan, debug_sync=True),
        max_seqs=2, device="cuda", store_root=str(root))
    st = eng.store
    tracked = all(isinstance(lk, sanitizer.TrackedLock)
                  for lk in (st._lock, st._pq_lock, st._futs_lock))
    active = sanitizer.active()
    rec = _spy_recovery(eng)
    _zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = {}
    for p in prompts:
        sid, tok = eng.begin_admission(p).drain()
        toks[sid] = tok
    admit_s = time.perf_counter() - t0
    rounds_s = []
    streams = _decode_rounds(eng, toks, FAULT_NEW_TOKENS - 1, rounds_s)
    torch.cuda.synchronize()
    launches = _launch_counts(cfg)
    fs = eng.fault_stats()
    failed = dict(eng.failed)
    for sid in list(streams):
        eng.release(sid)
    leaks = _engine_leaks(eng)
    st.close()
    del eng, st
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    row = {"prompts": [len(p) for p in prompts], "debug_sync": True,
           "locks_tracked": tracked, "sanitizer_active": active,
           "sanitizer_released": not sanitizer.active(),
           "events": [(e.site, e.index, e.kind, list(e.key)
                       if isinstance(e.key, tuple) else e.key)
                      for e in plan.fired_events()],
           "faults": fs, "failed": {str(k): v for k, v in failed.items()},
           "restored_chunks": [list(k) for k in rec["restored"]],
           "recover_s": rec["recover_s"], "admit_s": admit_s,
           "median_round_s": float(np.median(rounds_s)),
           "streams": {str(k): v for k, v in streams.items()},
           "launches": launches, "leaks": leaks}
    print(f"[faults-mla] {json.dumps(row)}")
    fails = []
    if not (tracked and active and row["sanitizer_released"]):
        fails.append("the sanitizer was not on for the run, or stayed on")
    if failed or any(len(v) != FAULT_NEW_TOKENS for v in streams.values()):
        fails.append(f"streams {streams}, failed {failed}")
    if not (fs["io_retries"] >= 1 and fs["checksum_failures"] >= 2
            and fs["chunks_recomputed"] >= 1):
        fails.append(f"fault counters {fs}")
    if leaks:
        fails.append(f"leaked {leaks}")
    zero = [k for k, v in launches.items() if v <= 0]
    if zero:
        fails.append(f"never launched {zero}")
    if fails:
        raise SystemExit("chip_smoke: [faults-mla] " + "; ".join(fails))
    return row


# ---------------------------------------------------------------------------
# Phase 4m: the remaining architectures (ROADMAP A11)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _check_engine_kernels(out):
    """Inside the block each kernel call of an engine round — B1 on the
    stacked abstracts (``chunk_bounds_gqa``), B2 over the pool slots
    (``sparse_decode_pooled``) and B3's dequant-and-scatter into the slab
    (``kv_dequant_scatter``) — is followed by its plain version on the
    same inputs: B1 within ``bounds_agreement``'s bar, B2 within
    ``bf16_agreement``'s (f32: 1e-5), B3 bitwise over the whole slab.
    Rows go into ``out[name]``."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.chunk_bounds import ops as cb
    from repro_torch.kernels.sparse_decode.ref import (BF16_MAX_MISMATCH,
                                                       bf16_agreement)
    from repro_torch.serving import engine as eng_mod
    from repro_torch.serving import offload
    from repro_torch.testing import bounds_agreement
    own = {"b1": cb.chunk_bounds_gqa, "b2": eng_mod.sparse_decode_pooled,
           "b3": offload.kv_dequant_scatter}

    def b1(q, *a, impl=None, **kw):
        res = own["b1"](q, *a, impl=impl, **kw)
        if build.use_kernel(impl, q):
            out.setdefault("chunk_bounds", []).append(bounds_agreement(
                res, own["b1"](q, *a, impl="ref", **kw)))
        return res

    def b2(q, *a, impl=None, **kw):
        res = own["b2"](q, *a, impl=impl, **kw)
        if build.use_kernel(impl, q):
            ref = own["b2"](q, *a, impl="ref", **kw)
            if q.dtype == torch.float32:
                err = (res - ref).abs().max().item()
                row = {"err": err, "bar": 1e-5, "ok": err <= 1e-5}
            else:
                err, bar, frac = bf16_agreement(res, ref)
                row = {"err": err, "bar": bar, "mismatch": frac,
                       "ok": err <= bar and frac <= BF16_MAX_MISMATCH}
            out.setdefault("sparse_decode", []).append(row)
        return res

    def b3(data, scale, slab, slots, *a, impl=None, **kw):
        if not build.use_kernel(impl, data):
            return own["b3"](data, scale, slab, slots, *a, impl=impl, **kw)
        want = slab.clone()
        own["b3"](data, scale, want, slots, *a, impl="ref", **kw)
        res = own["b3"](data, scale, slab, slots, *a, impl=impl, **kw)
        same = bool(slab.eq(want).all())
        out.setdefault("kv_dequant", []).append(
            {"err": 0.0 if same else 1.0, "bar": 0.0, "ok": same})
        return res

    cb.chunk_bounds_gqa, eng_mod.sparse_decode_pooled = b1, b2
    offload.kv_dequant_scatter = b3
    try:
        yield
    finally:
        cb.chunk_bounds_gqa = own["b1"]
        eng_mod.sparse_decode_pooled = own["b2"]
        offload.kv_dequant_scatter = own["b3"]


def _summarize_checks(checks):
    """Each kernel's calls against its plain version: count, largest
    error and bar, whether all held."""
    return {name: {"calls": len(rows),
                   "max_err": max(r.get("rel_err", r.get("err"))
                                  for r in rows),
                   "bar": max(r["bar"] for r in rows),
                   "all_ok": all(r["ok"] for r in rows)}
            for name, rows in checks.items()}


def _defs_bytes(cfg) -> int:
    """The bytes of a config's weights, from its parameter definitions
    (nothing allocated)."""
    from repro_torch.models import lm
    from repro_torch.models.params import is_def, tree_map
    sizes = []
    tree_map(lambda d: sizes.append(math.prod(d.shape) * (
        4 if d.dtype == "float32" else 2)), lm.param_defs(cfg),
        is_leaf=is_def)
    return sum(sizes)


def _init_a11(torch, name, n_layers=None):
    """One of the A11 configs at full width (``n_layers`` cuts its depth),
    bf16 random weights from seed 0 built on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    full = get_config(name)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    gb = sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e9
    print(f"[init] {name}: {cfg.n_layers} of {full.n_layers} layers "
          f"{list(cfg.layer_kinds())} mlp {list(cfg.mlp_kinds())}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"{n / 1e9!r} G params, {gb!r} GB in "
          f"{time.perf_counter() - t0!r} s")
    return cfg, params, {"params": n, "weight_gb": gb,
                         "layers": cfg.n_layers, "of": full.n_layers}


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _a11_preempt(np, torch, cfg, params, tag):
    """Suspend and resume one sequence of a hybrid stack: the 1536- and
    2048-token prompts, 2 rounds together, the second suspended for 2
    rounds of the first alone, resumed, 2 more rounds — against a run
    that only leaves it out of those 2 rounds.  Its recurrent state must
    come back bitwise, the streams and every round's logits must be
    equal."""
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    prompts = serve_prompts(np, cfg)[:2]
    runs = {}
    for suspend in (False, True):
        root = KV_ROOT / f"a11_preempt_{int(suspend)}"
        eng = BatchedLeoAMEngine(
            cfg, params, EngineCfg(max_len=MAX_LEN, real_codec=False,
                                   pipeline=False),
            max_seqs=2, device="cuda", store_root=str(root))
        eng._theta = lambda li: 0.5
        toks, streams, logits = {}, {}, []
        for p in prompts:
            sid, t = eng.add_sequence(p)
            toks[sid], streams[sid] = t, [t]
        a, b = sorted(toks)

        def rounds(live, n):
            for _ in range(n):
                got = eng.decode_round({s: toks[s] for s in live})
                logits.append(eng.last_logits.copy())
                for s, t in got.items():
                    toks[s] = t
                    streams[s].append(t)

        rounds([a, b], 2)
        same_state = True
        if suspend:
            before = [t.clone() for t in _leaves(eng.seqs[b].state)]
            eng.suspend_sequence(b)
        rounds([a], 2)
        if suspend:
            eng.resume_sequence(b)
            after = list(_leaves(eng.seqs[b].state))
            same_state = len(after) == len(before) and all(
                torch.equal(x, y) for x, y in zip(before, after))
        rounds([a, b], 2)
        runs[suspend] = (streams, logits, same_state)
        eng.store.close()
        del eng
        shutil.rmtree(root, ignore_errors=True)
        _free(torch)
    (s0, l0, _), (s1, l1, same_state) = runs[False], runs[True]
    row = {"streams_identical": s0 == s1,
           "logits_bitwise": len(l0) == len(l1) and all(
               np.array_equal(x, y) for x, y in zip(l0, l1)),
           "state_bitwise": same_state, "streams": {
               str(k): v for k, v in s1.items()}}
    print(f"{tag} {json.dumps(row)}")
    if not (row["streams_identical"] and row["logits_bitwise"]
            and same_state):
        raise SystemExit(f"chip_smoke: {tag} suspend/resume is not the "
                         f"identity: {row}")
    return row


def _a11_decode(np, torch, cfg, params, batch, S, steps, tag):
    """``lm.prefill`` then ``steps`` greedy ``lm.decode_step``s, twice
    from the same cache: the plain versions first (``impl="ref"``, each
    sparse layer's selection recorded), then kernels B1 and B2 replaying
    them, fed the plain run's tokens; the first kernel step's calls each
    held against their plain versions (``check_decode_kernels``).  Gates
    as phase 4l, with the logits held to ``A11_E2E_BAR`` (phase 5's) and
    ``TOL_E2E_ULPS`` bf16 ulps of max|logit| printed beside: the first
    tokens the same, B2 once per attention layer and step, B1 at least as
    often, every checked call within its bar."""
    from repro_torch.models import lm
    from repro_torch.testing import check_decode_kernels, replay_selections
    n_attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    B = batch["tokens"].shape[0] if "tokens" in batch else \
        batch["embeds"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, cache = lm.prefill(params, cfg, batch, max_len=MAX_LEN)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        kcache = _clone_tree(cache)
        tokens = [logits0.argmax(-1)]
        sels, ref_logits, ref_s = [], [], []
        with replay_selections(record=sels):
            for step in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = lm.decode_step(params, cfg, cache,
                                           {"token": tokens[-1]}, S + step,
                                           impl="ref")
                torch.cuda.synchronize()
                ref_s.append(time.perf_counter() - t0)
                ref_logits.append(lg.float().cpu().numpy())
                tokens.append(lg.argmax(-1))
        del cache
        _free(torch)
        _zero_launches()
        pairs, out, kern_s, checks = [], [], [], {}
        with replay_selections(replay=sels, pairs=pairs):
            for step in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with (check_decode_kernels(checks) if step == 0
                      else contextlib.nullcontext()):
                    lg, kcache = lm.decode_step(params, cfg, kcache,
                                                {"token": tokens[step]},
                                                S + step)
                torch.cuda.synchronize()
                kern_s.append(time.perf_counter() - t0)
                out.append(lg.float().cpu().numpy())
        launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cross = [tuple(c["cross_k"].shape) for c in kcache["prologue"]
             if c and "cross_k" in c][:1]
    del kcache, pairs, sels
    _free(torch)
    diffs = [float(np.abs(a - b).max()) for a, b in zip(out, ref_logits)]
    ulps = [TOL_E2E_ULPS * _bf16_ulp(float(np.abs(b).max()))
            for b in ref_logits]
    bars = [A11_E2E_BAR] * len(diffs)
    same = [int(a.argmax(-1)[i]) == int(b.argmax(-1)[i])
            for a, b in zip(out[:1], ref_logits[:1]) for i in range(B)]
    kc = _summarize_checks(checks)
    timed = kern_s[1:]
    row = {"batch": B, "prompt": S, "max_len": MAX_LEN, "steps": steps,
           "prefill_s": prefill_s, "median_step_s": float(np.median(timed)),
           "median_step_plain_s": float(np.median(ref_s)),
           "checked_first_step_s": kern_s[0], "peak_device_gib": peak,
           "kernel_checks": kc, "max_logit_diff": diffs, "bars": bars,
           "ulp_bars": ulps, "first_token_same": same, "launches": launches,
           **({"cross_kv_shape": cross[0]} if cross else {})}
    print(f"{tag} {json.dumps(row)}")
    fails = []
    if not all(d <= t for d, t in zip(diffs, bars)):
        fails.append(f"logits off the plain run's by {diffs} (bars {bars})")
    if not all(same):
        fails.append(f"first token differs: {same}")
    if launches["sparse_decode"] != steps * n_attn or \
            launches["chunk_bounds"] < steps * n_attn:
        fails.append(f"launches {launches} (B2 {steps * n_attn} wanted, B1 "
                     f"at least as many)")
    if not all(np.isfinite(x).all() for x in out):
        fails.append("non-finite logits")
    if kc.get("sparse_decode", {}).get("calls") != n_attn or \
            not all(c["all_ok"] for c in kc.values()):
        fails.append(f"kernel calls against their plain versions: {kc}")
    if fails:
        raise SystemExit(f"chip_smoke: {tag} " + "; ".join(fails))
    return row


def _a11_engine(np, torch, cfg, params, name):
    """A hybrid or M-RoPE stack through ``BatchedLeoAMEngine``: the 4
    requests through the batcher (min/max abstracts, real int4 codec,
    pipeline on, ``A11_NEW_TOKENS`` tokens), then plain against kernels
    as phase 5 with selections and experts replayed and the first kernel
    round's calls each held against their plain versions."""
    serve = phase_serve(np, torch, cfg, params, tag=f"[serve-{name}]",
                        new_tokens=A11_NEW_TOKENS)
    checks = {}
    try:
        e2e = phase_e2e(np, torch, cfg, params, tag=f"[e2e-{name}]",
                        check=checks, bar=A11_E2E_BAR)
    finally:
        kc = _summarize_checks(checks)
        print(f"[e2e-{name}] first kernel round's calls against their "
              f"plain versions: {json.dumps(kc)}")
    if not {"chunk_bounds", "sparse_decode"} <= set(kc) or \
            not all(c["all_ok"] for c in kc.values()):
        raise SystemExit(f"chip_smoke: [e2e-{name}] kernel calls against "
                         f"their plain versions: {kc}")
    return {"serve": serve, "e2e_max_diff": e2e, "kernel_checks": kc}


def _a11_vision(np, torch, cfg, params):
    """qwen2-vl through ``lm.prefill`` with 3-D M-RoPE positions, then
    ``lm.decode_step`` (:func:`_a11_decode`): ``DECODE_BATCH`` rows of a
    text head, an ``A11_PATCH_GRID``-square grid of patch embeddings and
    a text tail, ``A11_PROMPT`` rows in all.  Positions as Qwen2-VL gives
    them: text t = h = w = i; the grid's t fixed at its start, its h and
    w the row and column from there; the tail resumes after the grid's
    largest position.  Text rows are the embeddings of seeded random
    tokens, patch rows seeded normals at the embeddings' scale."""
    B, S = DECODE_BATCH, A11_PROMPT
    head, n = A11_VISION_HEAD, A11_PATCH_GRID
    tail = S - head - n * n
    g = torch.Generator(device="cuda").manual_seed(A11_SEED)
    toks = torch.randint(2, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    with torch.no_grad():
        emb = params["embed"][toks]
        patches = (torch.randn(B, n * n, cfg.d_model, generator=g,
                               device="cuda") * 0.02).bfloat16()
        emb[:, head:head + n * n] = patches
    i = torch.arange(head, device="cuda")
    r = torch.arange(n, device="cuda").repeat_interleave(n)
    c = torch.arange(n, device="cuda").repeat(n)
    grid = torch.stack([torch.full_like(r, head), head + r, head + c])
    t0 = head + n
    j = t0 + torch.arange(tail, device="cuda")
    pos = torch.cat([i[None].expand(3, head), grid, j[None].expand(3, tail)],
                    dim=1)
    pos = pos[:, None].expand(3, B, S).to(torch.int32)
    print(f"[decode-qwen2-vl] M-RoPE positions: text 0..{head - 1}, a "
          f"{n}x{n} grid at t={head} h,w={head}..{head + n - 1}, text "
          f"{t0}..{t0 + tail - 1}; decode at the cache length")
    return _a11_decode(np, torch, cfg, params,
                       {"embeds": emb, "positions": pos}, S, A11_DECODE_STEPS,
                       "[decode-qwen2-vl]")


def _a11_seamless(np, torch, cfg, params):
    """seamless-m4t-large-v2 through ``lm.prefill`` (the encoder over
    ``encoder_len(cfg, A11_PROMPT)`` seeded random frames, the decoder's
    cross K/V from it) and ``lm.decode_step`` (:func:`_a11_decode`): the
    self-attention sparse on B1/B2, the cross-attention dense."""
    from repro_torch.models import lm
    B, S = DECODE_BATCH, A11_PROMPT
    frames = lm.encoder_len(cfg, S)
    g = torch.Generator(device="cuda").manual_seed(A11_SEED)
    batch = {"tokens": torch.randint(2, cfg.vocab_size, (B, S),
                                     generator=g, device="cuda"),
             "embeds": torch.randn(B, frames, cfg.d_model, generator=g,
                                   device="cuda").bfloat16()}
    print(f"[decode-seamless] {frames} encoder frames "
          f"(encoder_len(cfg, {S})), {B} decoder prompts of {S} tokens")
    return _a11_decode(np, torch, cfg, params, batch, S, A11_DECODE_STEPS,
                       "[decode-seamless]")


def _a11_xlstm(np, torch, cfg, params):
    """xlstm-125m: prefill 4 x ``A11_PROMPT`` tokens, ``A11_XLSTM_STEPS``
    greedy decode steps; the last prefill logit against a decode step of
    the last token from prefill(S - 1), within ``TOL_E2E_ULPS`` bf16 ulps
    of max|logit|, the argmax the same."""
    from repro_torch.models import lm
    B, S = DECODE_BATCH, A11_PROMPT
    g = torch.Generator(device="cuda").manual_seed(A11_SEED)
    toks = torch.randint(2, cfg.vocab_size, (B, S), generator=g,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, cache = lm.prefill(params, cfg, {"tokens": toks},
                                 max_len=MAX_LEN)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        tok, step_s = full.argmax(-1), []
        for k in range(A11_XLSTM_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(params, cfg, cache, {"token": tok},
                                       S + k)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            tok = lg.argmax(-1)
        finite = bool(torch.isfinite(lg).all())
        del cache
        _, part = lm.prefill(params, cfg, {"tokens": toks[:, :S - 1]},
                             max_len=MAX_LEN)
        dec, _ = lm.decode_step(params, cfg, part, {"token": toks[:, -1]},
                                S - 1)
    a, b = dec.float().cpu().numpy(), full.float().cpu().numpy()
    diff = float(np.abs(a - b).max())
    bar = TOL_E2E_ULPS * _bf16_ulp(float(np.abs(b).max()))
    same = [int(a[i].argmax()) == int(b[i].argmax()) for i in range(B)]
    row = {"batch": B, "prompt": S, "prefill_s": prefill_s,
           "median_step_s": float(np.median(step_s)),
           "peak_device_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "decode_vs_prefill_max_diff": diff, "bar": bar,
           "argmax_same": same, "finite": finite}
    print(f"[xlstm] {json.dumps(row)}")
    del part
    _free(torch)
    if not (diff <= bar and all(same) and finite):
        raise SystemExit(f"chip_smoke: [xlstm] decode after prefill(S-1) "
                         f"is not prefill(S)'s last row: {row}")
    return row


def phase_a11(np, torch):
    """Phase 4m: the four families of ROADMAP A11 at full width, one model
    on the card at a time: jamba (its first ``A11_JAMBA_LAYERS`` layers)
    and qwen2-vl (all 28) through ``BatchedLeoAMEngine`` on B1-B3, jamba's
    suspend/resume; qwen2-vl with 3-D M-RoPE positions, and seamless
    (24 + 24 layers, cross-attention) through ``lm.prefill`` and
    ``lm.decode_step`` on B1/B2; xlstm-125m's prefill and decode."""
    import dataclasses
    out, launches = {}, {}

    def add(lc):
        for k, v in lc.items():
            launches[k] = launches.get(k, 0) + v

    cfg, params, init = _init_a11(torch, A11_JAMBA, A11_JAMBA_LAYERS)
    period = dataclasses.replace(cfg, n_layers=8)
    print(f"[depth] phase 4m (jamba): {A11_JAMBA_LAYERS} of {init['of']} "
          f"layers (3 Mamba with dense, MoE, dense MLPs, then attention "
          f"with MoE), full width: {init['weight_gb']!r} GB of weights "
          f"({_defs_bytes(cfg) / 1e9!r} GB from the definitions); the "
          f"first full 8-layer period would hold "
          f"{_defs_bytes(period) / 1e9!r} GB, above the card's 80 GB")
    try:
        t0 = time.perf_counter()
        out["jamba"] = _a11_engine(np, torch, cfg, params, "jamba")
        out["jamba"]["preempt"] = _a11_preempt(np, torch, cfg, params,
                                               "[preempt-jamba]")
        out["jamba"]["init"] = init
        out["jamba"]["wall_s"] = time.perf_counter() - t0
        add(out["jamba"]["serve"]["launches"])
    finally:
        del params
        _free(torch)
    cfg, params, init = _init_a11(torch, "qwen2-vl-2b")
    try:
        t0 = time.perf_counter()
        out["qwen2_vl"] = _a11_engine(np, torch, cfg, params, "qwen2-vl")
        out["qwen2_vl"]["decode"] = _a11_vision(np, torch, cfg, params)
        out["qwen2_vl"]["init"] = init
        out["qwen2_vl"]["wall_s"] = time.perf_counter() - t0
        add(out["qwen2_vl"]["serve"]["launches"])
        add(out["qwen2_vl"]["decode"]["launches"])
    finally:
        del params
        _free(torch)
    cfg, params, init = _init_a11(torch, "seamless-m4t-large-v2")
    try:
        t0 = time.perf_counter()
        out["seamless"] = _a11_seamless(np, torch, cfg, params)
        out["seamless"]["init"] = init
        out["seamless"]["wall_s"] = time.perf_counter() - t0
        add(out["seamless"]["launches"])
    finally:
        del params
        _free(torch)
    cfg, params, init = _init_a11(torch, "xlstm-125m")
    try:
        t0 = time.perf_counter()
        out["xlstm"] = _a11_xlstm(np, torch, cfg, params)
        out["xlstm"]["init"] = init
        out["xlstm"]["wall_s"] = time.perf_counter() - t0
    finally:
        del params
        _free(torch)
    out["launches"] = launches
    print(f"[a11] launches of B1-B3 on the phase's paths: "
          f"{json.dumps(launches)}")
    return out


# ---------------------------------------------------------------------------
# Phase 4n: the trainer (ROADMAP A12a)
# ---------------------------------------------------------------------------


def _busy_ms(kernels) -> float:
    """The device time that at least one kernel covers (merged intervals
    of (name, start_us, end_us)), in ms."""
    busy, end = 0.0, float("-inf")
    for b, e in sorted((b, e) for _, b, e in kernels):
        if e > end:
            busy += e - max(b, end)
            end = e
    return busy / 1e3


def _profile_once(torch, fn):
    """``fn()`` once under torch.profiler, CUDA activity only (tracing the
    host's ops too cost a 1.2 s train step 16 s): (its result, the CUDA
    kernels [(name, start_us, end_us)] from the first one's start)."""
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == cuda),
                 key=lambda e: e.time_range.start)
    t0 = evs[0].time_range.start if evs else 0
    return out, [(e.name, e.time_range.start - t0, e.time_range.end - t0)
                 for e in evs]


@contextlib.contextmanager
def _spy_train_steps(torch, record, profile_at=None, profiled=None):
    """Every step that ``launch.steps.make_train_step`` builds meanwhile
    is timed (synchronized) and its metrics appended to ``record``; the
    step numbered ``profile_at`` runs under torch.profiler, its kernels
    into ``profiled``."""
    from repro_torch.launch import steps
    orig = steps.make_train_step

    def make(cfg, tcfg):
        fn = orig(cfg, tcfg)

        def step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(record) == profile_at:
                (state, m), kernels = _profile_once(
                    torch, lambda: fn(state, batch))
                profiled.extend(kernels)
            else:
                state, m = fn(state, batch)
            torch.cuda.synchronize()
            record.append({"s": time.perf_counter() - t0,
                           **{k: float(v) for k, v in m.items()}})
            return state, m
        return step

    steps.make_train_step = make
    try:
        yield
    finally:
        steps.make_train_step = orig


def _loss_drop(losses, n):
    """(mean of the first n losses, mean of the last n)."""
    return (float(sum(losses[:n]) / n), float(sum(losses[-n:]) / n))


def _train_full(np, torch):
    """[train]: qwen3-1.7b at full width and depth through the CLI's
    ``main``, every step timed, the last one profiled."""
    from repro_torch.launch import train as train_cli
    record, profiled = [], []
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--microbatches", str(TRAIN_MICRO), "--log-every", "1"]
    print(f"[train] repro_torch.launch.train.main({argv})")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _spy_train_steps(torch, record, TRAIN_STEPS - 1, profiled):
        history = train_cli.main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [loss for _, loss in history]
    first, last = _loss_drop(losses, 4)
    timed = [r["s"] for r in record[1:TRAIN_STEPS - 1]]   # not 0, not profiled
    med = float(np.median(timed))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    busy = _busy_ms(profiled)
    row = {"arch": TRAIN_ARCH, "steps": len(losses), "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "microbatches": TRAIN_MICRO, "remat": "block",
           "lr": TRAIN_LR, "losses": losses,
           "first4_mean": first, "last4_mean": last,
           "median_step_s": med, "min_step_s": min(timed),
           "max_step_s": max(timed), "step0_s": record[0]["s"],
           "tokens_per_s": tokens / med, "peak_device_gib": peak,
           "grad_norm": [r["grad_norm"] for r in record],
           "lr_by_step": [r["lr"] for r in record],
           "profiled_step_s": record[-1]["s"],
           "cuda_kernels_in_step": len(profiled),
           "device_busy_ms": busy,
           "device_span_ms": profiled[-1][2] / 1e3 if profiled else None,
           "busy_share_of_median_step": busy / 1e3 / med,
           "wall_s": wall}
    print(f"[train] losses {json.dumps(losses)}")
    print(f"[train] grad_norm {json.dumps(row['grad_norm'])}")
    print(f"[train] lr {json.dumps(row['lr_by_step'])}")
    print(f"[train] median step {med!r} s (min {min(timed)!r}, max "
          f"{max(timed)!r}; step 0 {record[0]['s']!r} s), "
          f"{tokens / med!r} tokens/s, peak {peak!r} GiB")
    by_name = {}
    for name, b, e in profiled:
        short = re.sub(r"^void ", "", name).split("<")[0].split("(")[0]
        by_name[short] = by_name.get(short, 0.0) + (e - b) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row["top_kernels_ms"] = top
    print(f"[train] one step under torch.profiler: {len(profiled)} CUDA "
          f"kernels, device busy {busy!r} ms of a {med * 1e3!r} ms median "
          f"step ({busy / 1e3 / med!r}); the most device time: "
          f"{json.dumps(top)}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"chip_smoke: [train] a loss is not finite: "
                         f"{losses}")
    if not last < first - TRAIN_LOSS_DROP:
        raise SystemExit(f"chip_smoke: [train] the last 4 losses' mean "
                         f"{last!r} is not {TRAIN_LOSS_DROP} below the "
                         f"first 4's {first!r}")
    if len(losses) != TRAIN_STEPS or not profiled:
        raise SystemExit(f"chip_smoke: [train] {len(losses)} losses logged "
                         f"of {TRAIN_STEPS}, {len(profiled)} kernels traced")
    return row


def _cut_config(name, n_layers):
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(name)
    return dataclasses.replace(full, n_layers=n_layers), full


def _train_tcfg(cfg, steps, warmup):
    """The phase's TrainCfg: moments in the config's ``adam_dtype``."""
    from repro_torch.launch import steps as stp
    from repro_torch.optim import adamw
    adam = adamw.AdamWCfg(state_dtype=cfg.runtime.adam_dtype)
    return stp.TrainCfg(lr=TRAIN_LR, warmup_steps=warmup, total_steps=steps,
                        adam=adam)


def _train_setup(torch, cfg, steps, warmup):
    """A state on the card (weights from seed 0, moments in the config's
    ``adam_dtype``) and the train step for ``cfg``."""
    from repro_torch.launch import steps as stp
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    tcfg = _train_tcfg(cfg, steps, warmup)
    params = lm.init(cfg, seed=0, device="cuda")
    return ({"params": params, "opt": adamw.init_opt_state(params,
                                                           tcfg.adam)},
            stp.make_train_step(cfg, tcfg))


def _batches(cfg, n):
    from repro_torch.data.synthetic import DataCfg, ShardedLoader
    loader = ShardedLoader(DataCfg(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH))
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _bitwise(a, b) -> bool:
    """Same shape, dtype and bytes."""
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _mesh_train(torch):
    """[mesh-train] (in the deterministic child): qwen3 at
    ``TRAIN_CUT_LAYERS`` layers, ``MESH_TRAIN_STEPS`` steps of
    ``make_train_step`` without a mesh, then as many of
    ``make_jitted_train_step`` on a one-rank NCCL mesh from the same state
    laid out as DTensors by ``state_specs``, on the same batches: every
    parameter, moment, the step and each step's loss bitwise equal.
    Returns the row it prints."""
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps as stp
    from repro_torch.models import lm
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import whole
    t0 = time.perf_counter()
    cfg, full = _cut_config(TRAIN_ARCH, TRAIN_CUT_LAYERS)
    n = MESH_TRAIN_STEPS
    tcfg = _train_tcfg(cfg, n, warmup=1)
    batches = _batches(cfg, n)
    lmesh.init_distributed(0, 1, f"tcp://127.0.0.1:{lmesh.free_port()}",
                           "nccl", device="cuda")
    try:
        mesh = lmesh.make_host_mesh(1, 1)
        params = lm.init(cfg, seed=0, device="cuda")
        plain = {"params": params,
                 "opt": adamw.init_opt_state(params, tcfg.adam)}
        mstep, ss, _ = stp.make_jitted_train_step(
            cfg, mesh, tcfg, ShapeCfg("t", TRAIN_SEQ, TRAIN_BATCH, "train"))
        on_mesh = stp.distribute_tree(tree_map(torch.clone, plain), ss, mesh)
        step = stp.make_train_step(cfg, tcfg)
        losses = {"plain": [], "mesh": []}
        for b in batches:
            plain, m = step(plain, b)
            losses["plain"].append(m["loss"])
        t1 = time.perf_counter()
        for b in batches:
            on_mesh, m = mstep(on_mesh, b)
            losses["mesh"].append(m["loss"])
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t1
        from torch.distributed.tensor import DTensor
        dtensors = all(isinstance(x, DTensor) for x in leaves(on_mesh))
        same = all(_bitwise(whole(x), y) for x, y in
                   zip(leaves(on_mesh), leaves(plain)))
        loss_same = all(_bitwise(a, b) for a, b in zip(losses["mesh"],
                                                       losses["plain"]))
        row = {"layers": cfg.n_layers, "of": full.n_layers, "steps": n,
               "mesh": [1, 1], "backend": dist.get_backend(),
               "state_dtensors": dtensors, "state_bitwise": same,
               "loss_bitwise": loss_same,
               "losses": [float(x) for x in losses["mesh"]],
               "mesh_steps_s": mesh_s,
               "wall_s": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
    print(f"[depth] phase 4p (mesh-train): {cfg.n_layers} of "
          f"{full.n_layers} qwen3 layers, full width")
    print(f"[mesh-train] {json.dumps(row)}")
    print(f"[time] phase 4p mesh-train {row['wall_s']!r} s")
    if not (dtensors and same and loss_same):
        raise SystemExit(f"chip_smoke: [mesh-train] not bitwise: {row}")
    return row


def train_resume_child(mesh_train_only: bool = False) -> int:
    """[train-resume], run in a child process whose CUBLAS_WORKSPACE_CONFIG
    was set before its first cuBLAS call and with
    ``torch.use_deterministic_algorithms(True)`` (the backward of the
    embedding gather and of the attention's head repeat add with atomics
    otherwise): qwen3 at ``TRAIN_CUT_LAYERS`` layers, steps, a save, steps
    A; restore, the same steps B: A and B bitwise; then
    ``run_with_restarts`` from the checkpoint with one injected failure.
    Prints one ``[train-resume-json]`` line.  Then phase 4p's
    [mesh-train] (alone with ``mesh_train_only``), one
    ``[mesh-train-json]`` line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    if not mesh_train_only:
        _resume_in_child(torch)
    print("[mesh-train-json] " + json.dumps(_mesh_train(torch)))
    return 0


def _resume_in_child(torch):
    """[train-resume]'s runs and gates (see :func:`train_resume_child`)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.models.params import leaves
    from repro_torch.runtime.fault_tolerance import run_with_restarts
    R = TRAIN_RESUME_STEPS
    cfg, full = _cut_config(TRAIN_ARCH, TRAIN_CUT_LAYERS)
    print(f"[depth] phase 4n (train-resume): {cfg.n_layers} of "
          f"{full.n_layers} layers (the 2 prologue layers and 1 body "
          f"repeat), full width")
    state, step = _train_setup(torch, cfg, 2 * R, warmup=1)
    batches = _batches(cfg, 2 * R)
    shutil.rmtree(TRAIN_CKPT_ROOT, ignore_errors=True)
    ck = Checkpointer(str(TRAIN_CKPT_ROOT), keep=2, async_save=False)
    try:
        for b in batches[:R]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(R, state, block=True)
        save_s = time.perf_counter() - t0
        d = TRAIN_CKPT_ROOT / f"step_{R:08d}"
        ck_bytes = sum(f.stat().st_size for f in d.iterdir())
        s_a = state
        for b in batches[R:]:
            s_a, _ = step(s_a, b)
        t0 = time.perf_counter()
        restored, at = ck.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        round_trip = all(_bitwise(x, y) for x, y in zip(leaves(state),
                                                        leaves(restored)))
        s_b = restored
        for b in batches[R:]:
            s_b, _ = step(s_b, b)
        same = {part: all(_bitwise(x, y) for x, y in zip(
                    leaves(s_a[k1][k2] if k2 else s_a[k1]),
                    leaves(s_b[k1][k2] if k2 else s_b[k1])))
                for part, (k1, k2) in {"params": ("params", None),
                                       "m": ("opt", "m"), "v": ("opt", "v"),
                                       "step": ("opt", "step")}.items()}
        fail = {R + 2: True}

        def step_fn(i, s):
            if fail.pop(i, False):
                raise RuntimeError("injected worker failure")
            return step(s, batches[i])[0]

        final, stats = run_with_restarts(
            step_fn, restored, n_steps=2 * R, checkpointer=ck, save_every=0,
            restore_fn=ck.restore, start_step=R)
        restart_same = all(_bitwise(x, y) for x, y in zip(leaves(final),
                                                          leaves(s_a)))
        res = {"layers": cfg.n_layers, "saved_at": R, "restored_at": at,
               "checkpoint_bytes": ck_bytes, "save_s": save_s,
               "restore_s": restore_s, "round_trip_bitwise": round_trip,
               "bitwise": same, "restarts": stats.restarts,
               "failed_steps": stats.failed_steps,
               "final_step": int(final["opt"]["step"]),
               "restart_run_bitwise": restart_same}
    finally:
        ck.close()
        shutil.rmtree(TRAIN_CKPT_ROOT, ignore_errors=True)
    print(f"[train-resume] checkpoint of step {R}: {ck_bytes} B, save "
          f"{save_s!r} s, restore {restore_s!r} s; resumed run bitwise "
          f"{json.dumps(same)}; run_with_restarts: {stats.restarts} "
          f"restart(s) at {stats.failed_steps}, final step "
          f"{res['final_step']}, bitwise to the uninterrupted run "
          f"{restart_same}")
    print("[train-resume-json] " + json.dumps(res))
    if not (round_trip and all(same.values()) and restart_same
            and at == R and stats.restarts == 1
            and res["final_step"] == 2 * R):
        raise SystemExit(f"chip_smoke: [train-resume] failed: {res}")


# [mesh-train]'s row when phase 4n's child ran it in this call
MESH_TRAIN_ROW = {}


def _train_resume(mesh_train_only: bool = False):
    """Runs :func:`train_resume_child` in a child process; its failure
    fails the phase.  Keeps the child's [mesh-train] row in
    ``MESH_TRAIN_ROW``."""
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          TRAIN_CHILD_FLAG] + (
                              [MESH_TRAIN_ONLY_FLAG] if mesh_train_only
                              else []), env=env, capture_output=True,
                         text=True, timeout=600)
    print(res.stdout, end="")
    if res.returncode:
        print(res.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"chip_smoke: [train-resume] child exited "
                         f"{res.returncode}")
    rows = {}
    for ln in res.stdout.splitlines():
        for tag in ("[train-resume-json] ", "[mesh-train-json] "):
            if ln.startswith(tag):
                rows[tag] = json.loads(ln.split(" ", 1)[1])
    MESH_TRAIN_ROW.update(rows["[mesh-train-json] "])
    if mesh_train_only:
        return dict(MESH_TRAIN_ROW)
    out = rows["[train-resume-json] "]
    out["child_wall_s"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def _spy_forward_train(record):
    """The metrics of every ``lm.forward_train`` call meanwhile (the train
    step's own metrics hold loss and accuracy only, as the reference's)."""
    from repro_torch.models import lm
    orig = lm.forward_train

    def spy(params, cfg, batch, shards=None):
        loss, m = orig(params, cfg, batch, shards)
        record.append({k: float(v.detach()) for k, v in m.items()})
        return loss, m

    lm.forward_train = spy
    try:
        yield
    finally:
        lm.forward_train = orig


def _train_moe(np, torch):
    """[train-moe]: deepseek-v2-lite at ``TRAIN_CUT_LAYERS`` layers, MLA
    and the capacity-drop dispatch (64 experts, top 6), bf16 moments."""
    cfg, full = _cut_config(TRAIN_MOE_ARCH, TRAIN_CUT_LAYERS)
    print(f"[depth] phase 4n (train-moe): {cfg.n_layers} of "
          f"{full.n_layers} layers (dense layer 0, MoE layer 1, one MoE "
          f"body repeat), full width: {_defs_bytes(cfg) / 1e9!r} GB of "
          f"weights; all {full.n_layers} would hold "
          f"{_defs_bytes(full) / 1e9!r} GB before optimizer state")
    torch.cuda.reset_peak_memory_stats()
    state, step = _train_setup(torch, cfg, TRAIN_MOE_STEPS, warmup=2)
    batches = _batches(cfg, TRAIN_MOE_STEPS)
    fwd, times, losses = [], [], []
    with _spy_forward_train(fwd):
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    first, last = _loss_drop(losses, 2)
    drops = [r["moe_drop_frac"] for r in fwd]
    aux = {k: [r[k] for r in fwd] for k in ("moe_lb_loss", "moe_z_loss")}
    row = {"arch": TRAIN_MOE_ARCH, "layers": cfg.n_layers,
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "capacity_factor": cfg.moe.capacity_factor,
           "adam_dtype": cfg.runtime.adam_dtype, "losses": losses,
           "moe_drop_frac": drops, **aux,
           "median_step_s": float(np.median(times[1:])),
           "step0_s": times[0], "peak_device_gib": peak}
    n_moe = sum(m == "moe" for m in cfg.mlp_kinds())
    print(f"[train-moe] losses {json.dumps(losses)}; moe_drop_frac (summed "
          f"over the {n_moe} MoE layers, as the reference's metric) "
          f"{json.dumps(drops)}; median step {row['median_step_s']!r} s "
          f"(step 0 {times[0]!r} s), peak {peak!r} GiB")
    per_layer = [d / n_moe for d in drops]
    row["moe_drop_frac_per_layer"] = per_layer
    print(f"[train-moe] mean drop fraction per MoE layer "
          f"{json.dumps(per_layer)}; moe_lb_loss {json.dumps(aux['moe_lb_loss'])}"
          f"; moe_z_loss {json.dumps(aux['moe_z_loss'])}")
    finite = all(math.isfinite(x) for x in losses + sum(aux.values(), []))
    if not finite or not all(0.0 <= d < 1.0 for d in per_layer):
        raise SystemExit(f"chip_smoke: [train-moe] not finite or a layer's "
                         f"mean drop fraction outside [0, 1): {row}")
    if not last < first - TRAIN_LOSS_DROP:
        raise SystemExit(f"chip_smoke: [train-moe] the last 2 losses' mean "
                         f"{last!r} is not {TRAIN_LOSS_DROP} below the "
                         f"first 2's {first!r}")
    return row


def phase_train(np, torch):
    """Phase 4n: the trainer at full width — [train], [train-resume] (in
    a child process) and [train-moe].  No hand kernel lies on this path:
    the launch counts, zeroed before, must still be 0 after."""
    _zero_launches()
    t0 = time.perf_counter()
    out = {"train": _train_full(np, torch)}
    _free(torch)
    t1 = time.perf_counter()
    out["resume"] = _train_resume()
    t2 = time.perf_counter()
    out["moe"] = _train_moe(np, torch)
    _free(torch)
    print(f"[time] phase 4n: train {t1 - t0!r} s, train-resume (child "
          f"process) {t2 - t1!r} s, train-moe {time.perf_counter() - t2!r} s")
    counts = {**_launch_counts(), **_launch_counts(_mla_cfg())}
    out["launches"] = counts
    print(f"[train] hand-kernel launches on the trainer's paths: "
          f"{json.dumps(counts)}")
    if any(counts.values()):
        raise SystemExit(f"chip_smoke: the trainer launched a hand kernel: "
                         f"{counts}")
    return out


# ---------------------------------------------------------------------------
# Phase 4p: the device mesh (ROADMAP A12b) on the one card
# ---------------------------------------------------------------------------


def _mesh_model(np, torch, device):
    """longchat at ``MESH_LAYERS`` layers (full width, bf16 weights from
    seed 0, on this rank's card) and the phase's prompts."""
    from repro_torch.models import lm
    cfg, full = _cut_config("longchat-7b-32k", MESH_LAYERS)
    params = lm.init(cfg, seed=0, device=device)
    prompts = np.random.RandomState(MESH_SEED).randint(
        2, cfg.vocab_size, (MESH_BATCH, MESH_PROMPT))
    return cfg, full, params, prompts


def _mesh_steps(cfg, mesh):
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import steps as stp
    return (stp.make_jitted_prefill(cfg, mesh, ShapeCfg(
                "p", MAX_LEN, MESH_BATCH, "prefill")),
            stp.make_jitted_decode(cfg, mesh, ShapeCfg(
                "d", MAX_LEN, MESH_BATCH, "decode")))


def _mesh1_rank(rank, world, device):
    """[mesh-1] on a one-rank NCCL mesh (1, 1): ``make_jitted_prefill``
    and ``MESH_STEPS`` steps of ``make_jitted_decode`` (B1 and B2, the
    launches counted over them), then ``lm.prefill`` and as many
    ``lm.decode_step`` steps without a mesh on the same tokens: every
    step's logits and the final cache bitwise equal."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import leaves
    cfg, _, params, prompts = _mesh_model(np, torch, device)
    mesh = make_host_mesh(1, 1, device=device)
    prefill, decode = _mesh_steps(cfg, mesh)
    S, n = MESH_PROMPT, MESH_STEPS
    with torch.no_grad():
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": prompts})
        tokens, mesh_logits = [lg.argmax(-1)], [lg]
        _zero_launches()
        for t in range(n):
            lg, cache = decode(params, cache, {"token": tokens[-1]}, S + t)
            mesh_logits.append(lg)
            tokens.append(lg.argmax(-1))
        torch.cuda.synchronize(device)
        launches = _launch_counts()
        mesh_s = time.perf_counter() - t0
        lg, local = lm.prefill(params, cfg, {"tokens": torch.from_numpy(
            prompts).to(device)}, max_len=MAX_LEN)
        same = [_bitwise(lg, mesh_logits[0])]
        for t in range(n):
            lg, local = lm.decode_step(params, cfg, local,
                                       {"token": tokens[t]}, S + t)
            same.append(_bitwise(lg, mesh_logits[t + 1]))
        cache_same = all(_bitwise(a, b) for a, b in zip(leaves(cache),
                                                       leaves(local)))
    return {"backend": dist.get_backend(), "steps": n,
            "logits_bitwise": same, "cache_bitwise": cache_same,
            "launches": {k: launches[k] for k in ("chunk_bounds",
                                                  "sparse_decode")},
            "mesh_prefill_and_decode_s": mesh_s}


def _mesh4_rank(rank, world, device):
    """[mesh-4], one of four gloo ranks on the card, mesh (1, 4):
    ``MESH_SHARD_STEPS`` steps of ``make_jitted_decode`` with the plain
    versions (``impl="ref"``) recording each layer's selection on this
    shard, as many with B1 and B2 replaying them, then the dense decode
    (``min_seq_for_sparse`` raised) of the same tokens; rank 0 also runs
    the dense decode on the whole cache in this process.  Returns its
    logits (host), launches and shard fill."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.testing import replay_selections
    cfg, _, params, prompts = _mesh_model(np, torch, device)
    dense = dataclasses.replace(cfg, leoam=dataclasses.replace(
        cfg.leoam, min_seq_for_sparse=10 ** 9))
    mesh = make_host_mesh(1, 4, device=device)
    prefill, decode = _mesh_steps(cfg, mesh)
    _, decode_dense = _mesh_steps(dense, mesh)
    S, n = MESH_PROMPT, MESH_SHARD_STEPS
    S_l = MAX_LEN // 4
    out = {"rank": rank, "shard_rows": S_l,
           "shard_fill": [min(max(S + t + 1 - rank * S_l, 0), S_l)
                          for t in range(n)]}
    with torch.no_grad():
        lg, cache = prefill(params, {"tokens": prompts})
        kcache, dcache = _clone_tree(cache), _clone_tree(cache)
        tokens, sels = [lg.argmax(-1)], []
        out["ref"], out["kernels"], out["dense"] = [], [], []
        t0 = time.perf_counter()
        with replay_selections(record=sels):
            for t in range(n):
                lg, cache = decode(params, cache, {"token": tokens[-1]},
                                   S + t, impl="ref")
                out["ref"].append(lg.float().cpu().numpy())
                tokens.append(lg.argmax(-1))
        out["ref_s"] = time.perf_counter() - t0
        del cache
        _zero_launches()
        t0 = time.perf_counter()
        with replay_selections(replay=sels):
            for t in range(n):
                lg, kcache = decode(params, kcache, {"token": tokens[t]},
                                    S + t)
                out["kernels"].append(lg.float().cpu().numpy())
        torch.cuda.synchronize(device)
        out["kernels_s"] = time.perf_counter() - t0
        launches = _launch_counts()
        out["launches"] = {k: launches[k] for k in ("chunk_bounds",
                                                    "sparse_decode")}
        del kcache
        for t in range(n):
            lg, dcache = decode_dense(params, dcache, {"token": tokens[t]},
                                      S + t)
            out["dense"].append(lg.float().cpu().numpy())
        del dcache
        if rank == 0:
            _, whole = lm.prefill(params, dense, {"tokens": torch.from_numpy(
                prompts).to(device)}, max_len=MAX_LEN)
            out["local_dense"] = []
            for t in range(n):
                lg, whole = lm.decode_step(params, dense, whole,
                                           {"token": tokens[t]}, S + t)
                out["local_dense"].append(lg.float().cpu().numpy())
    out["tokens"] = [t.cpu().numpy() for t in tokens[:n]]
    return out


def _ulps_bar(np, ref):
    return TOL_E2E_ULPS * _bf16_ulp(float(np.abs(ref).max()))


def _mesh1(np, torch):
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    res = run_ranks(_mesh1_rank, 1, device="cuda", backend="nccl",
                    timeout_s=MESH_TIMEOUT_S)[0]
    res["wall_s"] = time.perf_counter() - t0
    print(f"[mesh-1] {json.dumps(res)}")
    print(f"[time] phase 4p mesh-1 {res['wall_s']!r} s")
    n = MESH_STEPS * MESH_LAYERS
    if not (all(res["logits_bitwise"]) and res["cache_bitwise"]):
        raise SystemExit(f"chip_smoke: [mesh-1] not bitwise: {res}")
    if res["launches"]["sparse_decode"] != n or \
            res["launches"]["chunk_bounds"] < n:
        raise SystemExit(f"chip_smoke: [mesh-1] launches {res['launches']} "
                         f"(B2 {n} wanted, B1 at least as many)")
    return res


def _mesh4(np, torch):
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(_mesh4_rank, 4, device="cuda", backend="gloo",
                      timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    bars = [_ulps_bar(np, b) for b in r0["ref"]]
    diffs = [float(np.abs(a - b).max()) for a, b in zip(r0["kernels"],
                                                       r0["ref"])]
    dense_bars = [_ulps_bar(np, b) for b in r0["local_dense"]]
    dense_diffs = [float(np.abs(a - b).max())
                   for a, b in zip(r0["dense"], r0["local_dense"])]
    same_across = all(np.array_equal(r["ref"][t], r0["ref"][t])
                      and np.array_equal(r["kernels"][t], r0["kernels"][t])
                      for r in ranks for t in range(MESH_SHARD_STEPS))
    first_same = [bool(a) for a in (r0["kernels"][0].argmax(-1)
                                    == r0["ref"][0].argmax(-1))]
    n = MESH_SHARD_STEPS * MESH_LAYERS
    row = {"mesh": [1, 4], "backend": "gloo", "steps": MESH_SHARD_STEPS,
           "shard_rows": r0["shard_rows"],
           "shard_fill_last_step": [r["shard_fill"][-1] for r in ranks],
           "launches_by_rank": [r["launches"] for r in ranks],
           "max_logit_diff": diffs, "bars": bars,
           "first_token_same": first_same,
           "dense_vs_local_diff": dense_diffs, "dense_bars": dense_bars,
           "logits_same_on_every_rank": same_across,
           "ref_steps_s": [r["ref_s"] for r in ranks],
           "kernel_steps_s": [r["kernels_s"] for r in ranks],
           "wall_s": wall}
    print(f"[mesh-4] {json.dumps(row)}")
    print(f"[time] phase 4p mesh-4 {wall!r} s")
    fails = []
    if not all(d <= b for d, b in zip(diffs, bars)):
        fails.append(f"kernel logits off the plain run's by {diffs} "
                     f"(bars {bars})")
    if not all(first_same):
        fails.append(f"first token differs: {first_same}")
    if not all(d <= b for d, b in zip(dense_diffs, dense_bars)):
        fails.append(f"dense mesh decode off the local one by "
                     f"{dense_diffs} (bars {dense_bars})")
    if not same_across:
        fails.append("ranks disagree on the combined logits")
    if ranks[3]["shard_fill"][-1] != 0 or not \
            0 < ranks[2]["shard_fill"][-1] < r0["shard_rows"]:
        fails.append(f"shard fills {row['shard_fill_last_step']}: shard 2 "
                     f"partly filled and shard 3 empty wanted")
    for r in ranks:
        if r["launches"]["sparse_decode"] != n or \
                r["launches"]["chunk_bounds"] < n:
            fails.append(f"rank {r['rank']} launches {r['launches']} (B2 "
                         f"{n} wanted, B1 at least as many)")
    if fails:
        raise SystemExit("chip_smoke: [mesh-4] " + "; ".join(fails))
    return row


def phase_mesh(np, torch):
    """Phase 4p: the device mesh on the one card — [mesh-1], [mesh-4] and
    [mesh-train] (run by phase 4n's deterministic child when 4n ran in
    this call, else by a child of its own), each with its ``[time]``.
    Every rank builds its weights from the seed, so the only collective on
    the card is the combine; each rank's B1 and B2 launches over its
    sharded decodes are added to the ``kernels`` line."""
    cfg, full = _cut_config("longchat-7b-32k", MESH_LAYERS)
    print(f"[depth] phase 4p (mesh-1, mesh-4): {cfg.n_layers} of "
          f"{full.n_layers} longchat layers (its 2 early layers and the "
          f"first body layers), full width; {MESH_BATCH} x {MESH_PROMPT} "
          f"tokens into a {MAX_LEN}-row cache")
    out = {"mesh1": _mesh1(np, torch), "mesh4": _mesh4(np, torch)}
    out["mesh_train"] = dict(MESH_TRAIN_ROW) or _train_resume(
        mesh_train_only=True)
    out["launches"] = {k: out["mesh1"]["launches"][k] + sum(
        r[k] for r in out["mesh4"]["launches_by_rank"])
        for k in ("chunk_bounds", "sparse_decode")}
    print(f"[mesh] B1/B2 launches over the sharded decodes: "
          f"{json.dumps(out['launches'])}")
    return out


# ---------------------------------------------------------------------------
# Phase 4q: the dry run (ROADMAP A12c)
# ---------------------------------------------------------------------------


def _rank_shape():
    """Rank 0's block of ``DRYRUN_SHAPE`` on the (16, 16) mesh, as a decode
    shape of its own: its batch rows (over ``decode_batch_axes``) and its
    cache rows (over ``seq_shard_axes``)."""
    from repro_torch.configs import get_shape
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    from repro_torch.sharding import partition as pt
    shape = get_shape(DRYRUN_SHAPE)
    sizes, names = PRODUCTION_SHAPES[False]
    mesh = pt.MeshShape(names, sizes)
    B = shape.global_batch // pt.mesh_extent(
        mesh, pt.decode_batch_axes(mesh, shape.global_batch))
    S = shape.seq_len // pt.mesh_extent(
        mesh, pt.seq_shard_axes(mesh, shape.global_batch))
    return ShapeCfg(f"{DRYRUN_SHAPE}_rank0", S, B, "decode")


def dryrun_child(n_cells: int) -> int:
    """Phase 4q (a), in a process of its own (the fake process group is
    process-global): the first ``n_cells`` of ``DRYRUN_CELLS`` on the
    (16, 16) mesh over a fake group of 256, then :func:`_rank_shape`'s
    cell on a (1, 1) mesh; one ``[dryrun-records]`` line."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    mesh = dryrun.production_mesh(False, "cuda")
    recs = [dryrun.lower_cell(arch, shape, mesh, device="cuda")
            for arch, shape in DRYRUN_CELLS[:n_cells]]
    one = dryrun.make_mesh((1, 1), ("data", "model"), "cuda")
    recs.append(dryrun.lower_cell(DRYRUN_ARCH, _rank_shape(), one,
                                  device="cuda",
                                  cfg=get_config(DRYRUN_ARCH)))
    print("[dryrun-records] " + json.dumps(recs), flush=True)
    return 0


def _dryrun_rank(rank, world, device):
    """Phase 4q (b) on a one-rank NCCL mesh: longchat at full width and
    depth, the parameters DTensors by ``param_specs``; the prefill, then
    ``DRYRUN_STEPS`` decode steps on the kernels — step 0 with every B1
    and B2 call held against its plain version, the middle steps timed,
    one profiled, the last (fill ``seq_len - 1``) counted by an
    ``OpCounter``.  Returns host numbers."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as stp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.testing import check_decode_kernels
    cfg = get_config(DRYRUN_ARCH)
    shape = _rank_shape()
    mesh = make_host_mesh(1, 1, device=device)
    whole = lm.init(cfg, seed=0, device=device)
    params = stp.distribute_tree(whole, stp.param_specs(cfg, mesh), mesh)
    prefill = stp.make_jitted_prefill(cfg, mesh, ShapeCfg(
        shape.name, shape.seq_len, shape.global_batch, "prefill"))
    decode = stp.make_jitted_decode(cfg, mesh, shape)
    rng = np.random.RandomState(DRYRUN_SEED)
    prompts = rng.randint(2, cfg.vocab_size,
                          (shape.global_batch, DRYRUN_PROMPT))
    out = {"shape": [shape.global_batch, shape.seq_len],
           "fills": [DRYRUN_PROMPT, DRYRUN_PROMPT + DRYRUN_STEPS - 1]}
    steps_s, checks = [], {}
    with torch.no_grad():
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": prompts})
        tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize(device)
        out["prefill_s"] = time.perf_counter() - t0
        del lg
        gc.collect()
        torch.cuda.reset_peak_memory_stats(device)
        _zero_launches()
        for t in range(DRYRUN_STEPS):
            fill = DRYRUN_PROMPT + t
            args = (params, cache, {"token": tok}, fill)
            if t == DRYRUN_STEPS - 1:
                assert fill == shape.seq_len - 1, fill
                counter = dryrun.trace_step(decode, args, n_devices=1)
                break
            if t == DRYRUN_STEPS - 2:
                (lg, cache), kern = _profile_once(torch,
                                                  lambda: decode(*args))
                wall = kern[-1][2] / 1e3 if kern else 0.0
                out["profile"] = {"cuda_kernels": len(kern),
                                  "device_busy_ms": _busy_ms(kern),
                                  "device_span_ms": wall}
            else:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                with (check_decode_kernels(checks) if t == 0
                      else contextlib.nullcontext()):
                    lg, cache = decode(*args)
                torch.cuda.synchronize(device)
                if t:
                    steps_s.append(time.perf_counter() - t0)
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize(device)
        out["measured_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    launches = _launch_counts()
    out["launches"] = {k: launches[k] for k in ("chunk_bounds",
                                                "sparse_decode")}
    out["steps_s"] = steps_s
    out["median_step_s"] = float(np.median(steps_s))
    out["counted"] = counter.cost.to_json()
    out["counted_memory"] = counter.memory()
    out["counted_ops"] = counter.ops
    out["kernel_checks"] = _summarize_checks(checks)
    out["n_layers"] = cfg.n_layers
    return out


def phase_dryrun(np, torch, n_cells: int = len(DRYRUN_CELLS)):
    """Phase 4q: (b) the measured rank, then (a) the dry-run child over
    the first ``n_cells`` of ``DRYRUN_CELLS`` (after the rank: a trace
    running beside it slowed its host-bound steps 2.7 times); their gates
    (see the module docstring)."""
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import run_ranks
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()           # the rank's process needs ~23 GB
    if n_cells < len(DRYRUN_CELLS):
        kept = ", ".join(" x ".join(c) for c in DRYRUN_CELLS[:n_cells])
        print(f"[depth] phase 4q (a): {n_cells} of {len(DRYRUN_CELLS)} "
              f"dry-run cells ({kept}); the others trace for minutes "
              f"(qwen3 x train_4k: 8 microbatches, about 360 000 ops) and "
              f"run under --phases 4q")
    rank = run_ranks(_dryrun_rank, 1, device="cuda", backend="nccl",
                     timeout_s=MESH_TIMEOUT_S)[0]
    rank_s = time.perf_counter() - t_phase
    child = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                              DRYRUN_CHILD_FLAG, str(n_cells)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        cout, cerr = child.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t_phase - rank_s
    for line in cout.splitlines():
        if line.startswith("[dryrun] "):
            print(line)
    recs = [json.loads(line.split(" ", 1)[1]) for line in cout.splitlines()
            if line.startswith("[dryrun-records] ")]
    if child.returncode != 0 or not recs:
        raise SystemExit(f"chip_smoke: [dryrun] child exited "
                         f"{child.returncode}:\n{cout[-3000:]}\n"
                         f"{cerr[-3000:]}")
    recs = recs[-1]
    for rec in recs:
        print(f"[dryrun-record] {json.dumps(rec)}")
    for rec in recs[:-1]:          # the (16, 16) cells of SHAPES
        print(f"[roofline] {json.dumps(roofline.analyze_cell(rec))}")
    ref = recs[-1]
    oc, got = ref["op_cost"], rank["counted"]
    bound_s = max(oc["flops"] / roofline.PEAK_FLOPS,
                  oc["bytes"] / roofline.HBM_BW)
    prof = rank.get("profile", {})
    busy = (prof["device_busy_ms"] / prof["device_span_ms"]
            if prof.get("device_span_ms") else None)
    peak_trace = ref["memory"]["peak_bytes_per_device"]
    peak_rel = rank["measured_peak_bytes"] / peak_trace - 1.0
    row = {"cell": f"{ref['arch']} x {ref['shape']} x {ref['mesh']}",
           "batch_rows": rank["shape"], "fills": rank["fills"],
           "prefill_s": rank["prefill_s"],
           "median_step_s": rank["median_step_s"],
           "steps_s": rank["steps_s"],
           "roofline_bound_s": bound_s,
           "fraction_of_bound": bound_s / rank["median_step_s"],
           "profiled_step": prof, "device_busy_share": busy,
           "traced": {"flops": oc["flops"], "bytes": oc["bytes"],
                      "collective_counts": oc["collective_counts"],
                      "peak_bytes": peak_trace, "ops": ref["ops"]},
           "counted": {"flops": got["flops"], "bytes": got["bytes"],
                       "collective_counts": got["collective_counts"],
                       "ops": rank["counted_ops"],
                       "memory": rank["counted_memory"]},
           "measured_peak_bytes": rank["measured_peak_bytes"],
           "peak_rel_to_trace": peak_rel,
           "launches": rank["launches"],
           "kernel_checks": rank["kernel_checks"],
           "rank_s": rank_s, "child_s": child_s,
           "wall_s": time.perf_counter() - t_phase}
    print(f"[dryrun-step] {json.dumps(row)}")
    fails = []
    if (got["flops"], got["bytes"], got["collective_counts"]) != \
            (oc["flops"], oc["bytes"], oc["collective_counts"]):
        fails.append(f"the card's count {row['counted']} is not the "
                     f"trace's {row['traced']}")
    n = (DRYRUN_STEPS) * rank["n_layers"]
    if rank["launches"]["sparse_decode"] != n or \
            rank["launches"]["chunk_bounds"] < n:
        fails.append(f"launches {rank['launches']} (B2 {n} wanted, B1 at "
                     f"least as many)")
    kc = rank["kernel_checks"]
    if set(kc) != {"chunk_bounds", "chunk_bounds_gqa", "sparse_decode"} \
            or not all(c["all_ok"] for c in kc.values()):
        fails.append(f"kernel calls against their plain versions: {kc}")
    if not abs(peak_rel) <= DRYRUN_PEAK_REL:
        fails.append(f"measured peak {rank['measured_peak_bytes']} B is "
                     f"{peak_rel:+.3f} off the trace's {peak_trace} B")
    if not all(r["op_cost"]["flops"] > 0 for r in recs) or [
            r["n_devices"] for r in recs] != [256] * n_cells + [1]:
        fails.append("a dry-run record is empty or on another mesh")
    if fails:
        raise SystemExit("chip_smoke: [dryrun] " + "; ".join(fails))
    return {"records": recs, "step": row, "launches": rank["launches"]}


def _mla_cfg():
    from repro_torch.configs import get_config
    return get_config(MLA_ARCH)


def init_longchat(torch):
    """longchat-7b-32k at full width, random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = get_config("longchat-7b-32k")
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[init] longchat-7b-32k full width: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.dtype}, "
          f"{sum(p.numel() for p in _leaves(params)) / 1e9!r} G params in "
          f"{time.perf_counter() - t0!r} s")
    return cfg, params


def cut_depth(cfg, params, n_layers):
    """A model at ``n_layers`` of its depth: the same widths, its prologue
    layers and the first body layers' weights (views of the full model's
    stacked leaves, no copy)."""
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


def cut_for(phase, cfg, params):
    """longchat at ``SERVE_MODES_LAYERS`` layers for one phase (4b, 4c,
    4f, 4h, 4i, 4j, 4o), with its ``[depth]`` line."""
    print(f"[depth] phase {phase}: {SERVE_MODES_LAYERS} of {cfg.n_layers} "
          f"layers, full width")
    return cut_depth(cfg, params, SERVE_MODES_LAYERS)


def _serve_modes(np, torch, cfg, params):
    """Phase 4d's two serves at ``SERVE_MODES_LAYERS`` layers."""
    cut, cut_params = cut_depth(cfg, params, SERVE_MODES_LAYERS)
    print(f"[depth] phase 4d (serve-async, serve-chunked): "
          f"{SERVE_MODES_LAYERS} of {cfg.n_layers} layers, full width")
    return [phase_serve(np, torch, cut, cut_params, mode=m)
            for m in ("async", "chunked")]


def _serve_sidecar(np, torch, cfg, params):
    """Phase 4e's serve at ``SERVE_MODES_LAYERS`` layers."""
    cut, cut_params = cut_depth(cfg, params, SERVE_MODES_LAYERS)
    print(f"[depth] phase 4e (serve-sidecar): {SERVE_MODES_LAYERS} of "
          f"{cfg.n_layers} layers, full width")
    return phase_serve(np, torch, cut, cut_params, sidecar=True)


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
