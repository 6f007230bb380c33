"""LeoAM serving engine: batched tiered decoding on a live model (PyTorch).

The port of ``repro.serving.engine`` for decoder-only models: GQA/MHA
(the paper's own model, longchat-7b-32k; qwen2-vl with its M-RoPE
positions), DeepSeek-class absorbed MLA with mixture-of-experts
feed-forwards (deepseek-v2-lite), and hybrids whose attention layers sit
between recurrent ones (Jamba's Mamba layers).  Prefill populates the
three-tier store with every attention layer's K/V; each decode round runs,
per attention layer, the paper's Dynamic Three-tier Pipeline (§4.4):

1. **Evaluate**: one bounds product over the stacked per-request queries
   and the layer's padded abstract stack — kernel B1
   (``core.bounds.chunk_bounds_gqa_matmul``) — then chunk-level adaptive
   selection (IAKM tree or flat) per sequence on the host.
2. **Transfer**: one batch-coalesced disk gather stages cold chunks
   host-side; the device chunk pool uploads ONLY the newly-promoted delta,
   and with ``real_codec`` the θ-fraction of it crosses packed and is
   dequantized on the device — kernel B3.
3. **Attend**: sparse attention over the pool slots plus the new token —
   kernel B2 (``kernels.sparse_decode.sparse_decode_pooled``) — then the
   output projection and the append.

A recurrent layer has no K/V to tier: its fixed-size decode state (Mamba's
conv window and SSM state) stays on the device in the sequence's
``_SeqState.state``, from the admission's prefill in every admission mode,
and each round steps the batch's states stacked in one decode step: the
rows are independent, as in the reference's per-sequence ``run_other``,
and the layer's weights and MLP are read once a round, not once a
sequence.  The round's new states are committed only once the round has
run to its end, so a round that is re-run after a chunk loss steps them
once.  Suspend and resume keep the state as it is.  An
encoder-decoder model (seamless) raises the reference's ``ValueError``
(serve it with ``lm.prefill`` / ``lm.decode_step``), and so does a stack
with no attention layer (xlstm), where the reference fails inside its
store.

An MLA model tiers ONE latent row per token (concat(c_kv, k_rope), one
logical kv head of width kv_lora_rank + qk_rope_head_dim) in a
``latent=True`` store.  Evaluate bounds concat(q_lat, q_rope) — W_UK
absorbed into the query — against the latent boxes on B1's latent
variant (``kernels.chunk_bounds.ops.chunk_bounds_latent``); attend runs
B2's latent variant (``kernels.sparse_decode.sparse_decode_latent_pooled``)
over the latent rows and applies W_UV and the output projection
afterwards; admission in every mode streams latent rows through
``ingest``.

With ``pq_abstracts`` the store keeps a PQ abstract plane (codebooks
trained at ingest on kernels B4 and B5); evaluate then scores chunks whose
codes are fresh by asymmetric distance (``kernels.pq.adc_chunk_scores``)
and keeps the min/max bound bitwise for the rest.  With ``disk_sidecar``
the store keeps a packed int4/int8 replica beside the fp16 one, and
disk→host promotions read (and bill) the packed bytes.  Each round ends
with the requant sweep, which repacks the sidecar and re-encodes the codes
of quiet append-dirtied chunks.

``pooled=False`` is the reference's synchronous full-re-upload path: the
store assembles each layer's padded working set on the host
(``fetch_chunks_batch`` over the legacy device tier) and the engine
uploads it whole to the card, where kernel B2 attends over it in place
(``kernels.sparse_decode.sparse_decode_workingset``) — the pooled call's
kernel, mask and split plan over the same fp16 rows, so the two paths give
the same tokens.

With ``pipeline=True`` a one-worker prefetch executor overlaps layer l+1's
abstract reads and speculative disk staging under layer l's attention;
predictions only move residency, so output is bit-identical to
``pipeline=False``.

Admission has three modes, all with write-behind ingest (replica, CRC
and abstract writes on the prefetch worker, behind a per-sequence
fence) unless ``overlap_ingest=False``, which forces the whole prefill
to the host and writes every layer inline (the reference's serial
ingest, the baseline its write-behind is measured against):

* ``add_sequence`` — synchronous, bucketed prefill on the decode thread;
* ``add_sequence_async`` — overlapped: the whole prefill and ingest run on
  a one-worker admission thread (``leoam-admit``, its own CUDA stream)
  under the batch's decode rounds; device placements are deferred into
  the pool's ``pending_place`` and folded in by the next decode round;
* ``begin_admission`` — chunked: a :class:`ChunkedAdmission` whose
  ``step()`` prefills one fixed-size chunk over the decode cache and
  streams it into the store, so decode rounds run between a long prompt's
  chunks.

Overlapped admission stores exactly the synchronous bytes.  Chunked
prefill runs other GEMM shapes (M = chunk rows), so in bf16 its K/V may
round differently; in f32 all three modes store the same bytes and give
the same token streams, as in the reference (tested).

Failure containment: a sequence whose write-behind ingest failed is failed
alone at its fence, and a disk-lost chunk (a replica that fails its CRC or
stays unreadable past the store's retry budget) is recomputed from the
prompt by replaying chunked prefill, or fails its sequence alone when it
holds decode appends; the round then re-runs.  ``EngineCfg.fault_plan``
injects such faults at the store's choke points.  Overload control:
:meth:`BatchedLeoAMEngine.suspend_sequence` swaps a live sequence's working
set down to its disk replica and parks it, and ``resume_sequence`` re-stages
it — the identity on its token stream.

With ``prefix_cache=True`` (the content-addressable shared-prefix cache)
every admission is a chunked prefill: the prompt's chain-hashed chunk
prefix is matched against the store's index of published chunks, the hits
are adopted by reference (no prefill, no tier bytes), their rows are
loaded into the admission's cache off the registrant's fidelity rows
(``lm.load_prefix_rows``) and prefill resumes at the cold suffix — bitwise
the cold chunked prefill it skips.  The chunks it misses are registered
into an arena row and published once their writes have landed.

Every kernel runs on the engine's device when it is the CUDA card; on the
CPU (``device="cpu"``) the plain PyTorch versions run.  ``impl="ref"``
asks for the plain versions on the card too.
``EngineCfg(debug_sync=True)`` turns on the runtime sync sanitizer
(``serving/sanitizer.py``) through the store, as the reference does.

Each decode round appends one dict to ``round_profiles`` (keys
``ROUND_KEYS``), host wall seconds summed over the round's layers and
always taken:

* ``total_s``: the round, from its first layer to the next tokens (the
  argmax included);
* the parts that do not overlap (``ROUND_PARTS``; ``total_s`` less their
  sum is the round's self time: the selection bookkeeping, the prefetch
  submission and the fetch outside its two stages):
  ``dense_s`` (``rms_norm``, the QKV or MLA query with qk-norm and RoPE,
  the attend launch through the output projection, the MLP; recurrent
  layers whole), ``logits_s`` (final norm and head, the logits' copy to
  the host, the argmax), ``eval_s`` (evaluate), ``gather_s`` and
  ``upload_s`` (the tier fetch's disk stage and upload),
  ``append_copy_s`` (the new K/V rows' copies to the host, which wait
  for the layer's queued work) and ``append_store_s``
  (``append_tokens_batch``);
* evaluate's split, whose parts share their end points and add up to
  ``eval_s``: ``eval_wait_s`` (the prefetch worker's future, where there
  is one), ``eval_read_s`` (the call itself and the abstracts, read here
  on a speculation miss), ``eval_bounds_s`` (their upload, the bounds
  product and its copy back) and ``eval_select_s`` (the per-sequence
  selection, to the call's return);
* counters: ``spec_misses`` (layers whose abstracts missed the prefetch
  cache) and ``lock_wait_s`` (seconds the decode thread was blocked on
  the store lock, inside any part);
* ``attend_s``: with ``EngineCfg(profile=True)`` each attention layer's
  attend call timed between two synchronizations of the engine's CUDA
  stream, summed; without it the rest of the round (``total_s`` less
  ``eval_s``, ``gather_s`` and ``upload_s``), an upper bound.  The θ
  balance reads ``attend_s`` either way.

Each part and stage also opens a ``leoam.*`` profiler range while a
``torch.profiler`` session runs (``serving/spans.py``).

``BatchedLeoAMEngine.on_round`` (default None), set before the first
admission, is called at the end of every decode round with a
:class:`RoundRecord`: the round's ``order`` and ``lengths`` (the position
each sequence decoded), its ``selections`` by sequence and attention
layer, ``int4`` (for each selected chunk the pool holds as int4 transit
payload, the rows it holds: set when a codec upload writes the slot,
cleared when the slot is allocated again or written plain; rows appended
later land exact) and its ``round_profiles`` entry.  A round re-run after
a chunk loss reports once, its last run.  Unset, a round reads the one
attribute and the pools keep no int4 record.

``EngineCfg`` has every field of the reference's but ``jit_prefill``:
eager PyTorch compiles no prefill program, so there is nothing to turn
off.  ``prefill_programs`` still counts the distinct prefill shapes (the
padded whole-prompt lengths and the chunk-step sizes), which is what the
reference's count of compiled programs is.
"""

from __future__ import annotations

import contextlib
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core import pipeline as dtp
from repro_torch.core.adaptive import flat_select_chunks, tree_select_chunks
from repro_torch.core.bounds import chunk_bounds_gqa_matmul
from repro_torch.core.tiers import AccessTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.chunk_bounds.ops import chunk_bounds_latent
from repro_torch.kernels.pq.ops import adc_chunk_scores
from repro_torch.kernels.sparse_decode.ops import (
    sparse_decode_latent_pooled, sparse_decode_latent_workingset,
    sparse_decode_pooled, sparse_decode_workingset)
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.models.common import rms_norm, scale_like
from repro_torch.models.params import torch_dtype
from repro_torch.serving.faults import AdmissionError, ChunkLostError
from repro_torch.serving.offload import DEVICE, DISK, HOST, TieredKVStore
from repro_torch.serving.sanitizer import decode_thread_only, worker_thread
from repro_torch.serving.spans import Laps, span


@dataclass
class EngineCfg:
    max_len: int = 1024
    gpu_chunk_frac: float = 0.15     # device-resident fraction
    cpu_chunk_frac: float = 0.45     # host tier fraction (rest -> disk)
    selection: str = "tree"          # tree | flat
    hot_frac: float = 0.05
    transit_codec: Optional[str] = "int4"
    sel_pad: int = 4                 # pad round working sets to a multiple
                                     # of this many chunks (masking keeps
                                     # it exact)
    pooled: bool = True              # device-resident chunk pool (delta
                                     # uploads); False = the synchronous
                                     # full re-upload of each round's
                                     # working set
    pipeline: bool = True            # async DTP overlap (prefetch thread)
    real_codec: bool = False         # carry actual packed int4/int8 transit
                                     # payloads (vs ledger-only scaling)
    overlap_ingest: bool = True      # write-behind prefill ingest: replica/
                                     # abstract writes ride the prefetch
                                     # worker behind a per-sequence fence;
                                     # False = serial ingest (the whole
                                     # prefill on the host, then every
                                     # layer written inline)
    bucket_prefill: bool = True      # pad prompts to power-of-two (or
                                     # prefill_buckets) lengths with the
                                     # true length threaded through —
                                     # token-identical to exact length
                                     # (False: exact length)
    prefill_buckets: Optional[Tuple[int, ...]] = None
                                     # explicit bucket schedule (None =
                                     # powers of two from 16)
    prefill_chunk_tokens: int = 64   # chunk size of begin_admission's
                                     # chunked prefill; must divide max_len
                                     # and be a multiple of the store chunk
    sidecar_requant: bool = True     # background sweep repacks the disk
                                     # sidecar and re-encodes the PQ codes
                                     # of append-dirtied chunks once a
                                     # chunk goes a full round without
                                     # appends (no-op unless disk_sidecar
                                     # or pq_abstracts)
    disk_sidecar: bool = False       # packed int4/int8 disk replicas: tier
                                     # writes + disk->host promotions move
                                     # packed bytes (fp16 stays as the
                                     # lossless fallback)
    sidecar_lossless: bool = False   # promotions read the fp16 replica
                                     # (full bytes) even when the sidecar
                                     # is valid
    pq_abstracts: bool = False       # PQ abstract plane: per-layer online
                                     # k-means codebooks over ingested key
                                     # chunks; evaluation scores code-valid
                                     # chunks by ADC and falls back BITWISE
                                     # to the bounds product for the rest
    pq_m: Optional[int] = None       # key subvectors per head dim (None =
                                     # head_dim // 8)
    pq_centroids: int = 256          # codebook entries per subspace (<= 256)
    pq_train_iters: int = 4          # Lloyd iterations on the first
                                     # (codebook-initializing) ingest
    prefix_cache: bool = False       # content-addressable cross-request
                                     # shared-prefix reuse: warm prompts
                                     # adopt matching chunk-aligned spans
                                     # by reference (no prefill, no
                                     # duplicate tier bytes) and resume
                                     # chunked prefill at the cold suffix;
                                     # every admission runs chunked
    prefix_arena_rows: int = 8       # shared-chunk arena rows after the
                                     # store's sequence rows: how many
                                     # distinct prefix sets stay resident
                                     # (LRU beyond that)
    profile: bool = False            # time each layer's attend call
                                     # behind stream synchronizations, fill
                                     # round_profiles' attend_s with it
    debug_sync: bool = False         # runtime sync sanitizer: ownership
                                     # assertions and TrackedLock order
    checksums: bool = True           # per-chunk CRC32 on disk replicas +
                                     # packed sidecars, verified at every
                                     # promotion
    fault_plan: Optional[Any] = None  # serving.faults.FaultPlan consulted
                                     # at the store's I/O choke points
                                     # (chaos tests and chip_smoke only)
    io_retries: int = 3              # bounded retry budget on transient
    io_backoff_s: float = 1e-4       # disk errors, exponential backoff
    # measured-cost θ balance (paper §4.4); defaults mirror TierBW
    pcie_bw: float = 16e9
    disk_bw: float = 3.5e9
    kappa: float = 1.0 / 80e9


# one process-wide DTP prefetch worker, shared by every pipelined engine
# (per-engine executors would leak a thread per engine); its FIFO order
# also orders write-behind ingest before any later prefetch
_PF_EXECUTOR: Optional[ThreadPoolExecutor] = None


# a separate one-worker admission executor runs whole add_sequence_async
# calls (prefill + ingest) under the batch's decode rounds — on the DTP
# worker a long prefill would stall every round's prefetch
_ADMIT_EXECUTOR: Optional[ThreadPoolExecutor] = None


def _prefetch_executor() -> ThreadPoolExecutor:
    global _PF_EXECUTOR
    if _PF_EXECUTOR is None:
        _PF_EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="leoam-dtp")
    return _PF_EXECUTOR


def _admit_executor() -> ThreadPoolExecutor:
    global _ADMIT_EXECUTOR
    if _ADMIT_EXECUTOR is None:
        _ADMIT_EXECUTOR = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="leoam-admit")
    return _ADMIT_EXECUTOR


@dataclass
class StepStats:
    evaluations: int = 0
    fetched_chunks: int = 0
    abstract_bytes: float = 0.0


# the keys of each ``round_profiles`` entry (module docstring); summed over
# the round's layers, ``spec_misses`` a count, the rest seconds
ROUND_KEYS = ("eval_s", "gather_s", "upload_s", "attend_s", "total_s",
              "dense_s", "logits_s", "append_copy_s", "append_store_s",
              "eval_wait_s", "eval_read_s", "eval_bounds_s", "eval_select_s",
              "spec_misses", "lock_wait_s")
# the parts of a round that do not overlap: total_s less their sum is the
# round's self time
ROUND_PARTS = ("dense_s", "logits_s", "eval_s", "gather_s", "upload_s",
               "append_copy_s", "append_store_s")


@dataclass
class RoundRecord:
    """What one decode round did, handed to
    :attr:`BatchedLeoAMEngine.on_round` at the round's end."""
    order: List[int]                   # seq ids in the round's row order
    lengths: Dict[int, int]            # seq id -> its length as the round
                                       # began: the position it decoded
    selections: Dict[int, Dict[int, List[int]]]
                                       # seq id -> attention layer index ->
                                       # the chunk ids it attended
    int4: Dict[int, Dict[int, Dict[int, int]]]
                                       # seq id -> layer -> {chunk: rows}
                                       # of the selected chunks the pool
                                       # holds as int4 transit payload
                                       # (layers with none left out)
    profile: Dict[str, float]          # the round's round_profiles entry


@dataclass
class _SeqState:
    """Per-sequence decode state.  The tier store holds every K/V row, so
    only the recurrent layers' state is kept here: ``{"prologue": [per
    layer, None for attention], "body": [per period position, stacked on
    the repeat axis, None for attention]}`` on the engine's device, or
    None for an attention-only stack."""
    length: int
    access: AccessTable
    state: Optional[Dict[str, Any]] = None
    prefill_logits: Optional[np.ndarray] = None  # (V,) behind the first
                                     # token, for end-to-end checks
    stats: List[StepStats] = field(default_factory=list)
    tokens: Optional[np.ndarray] = None  # prompt tokens (recompute source
                                     # for disk-lost prompt-span chunks)
    prompt_len: int = 0              # tokens covered by the prompt: only
                                     # chunks entirely within it are
                                     # recomputable (decode appends exist
                                     # nowhere but the lost replica)


def group_sum(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, H, hd) -> (B, Hkv, hd): each kv group's queries added in group
    order, one rounding per add in q's dtype — the reference's numpy
    ``q.reshape(B, Hkv, G, hd).sum(2)``."""
    B, H, hd = q.shape
    q4 = q.reshape(B, kv_heads, H // kv_heads, hd)
    out = q4[:, :, 0]
    for g in range(1, q4.shape[2]):
        out = out + q4[:, :, g]
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A model-dtype tensor as numpy (bfloat16 crosses as float32, exact)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class BatchedLeoAMEngine:
    """Batched tiered-decoding engine over an attention-only decoder.

    Sequences join via :meth:`add_sequence`, decode together via
    :meth:`decode_round`, and leave via :meth:`release` — the surface
    :class:`~repro_torch.serving.scheduler.ContinuousBatcher` drives.
    ``params`` must already live on ``device``."""

    def __init__(self, cfg, params, ecfg: EngineCfg, *, max_seqs: int = 1,
                 device_chunk_budget: Optional[int] = None,
                 device: DeviceLike = None, impl: Optional[str] = None,
                 store_root: Optional[str] = None):
        if cfg.is_encdec:
            raise ValueError(
                f"LeoAMEngine drives decoder-only models; '{cfg.name}' is "
                f"an encoder-decoder architecture — serve it with the "
                f"per-request runtime paths instead")
        if ecfg.prefix_cache:
            bad = sorted({k for k in cfg.layer_kinds()
                          if not k.startswith("attn")})
            if bad:
                # recurrent blocks carry decode state outside the KV
                # store, which an adoption by reference cannot rebuild
                raise ValueError(
                    f"prefix_cache requires an attention-only stack; "
                    f"'{cfg.name}' has non-attention layers {bad} whose "
                    f"recurrent decode state the shared-prefix cache "
                    f"cannot adopt by reference")
            C = ecfg.prefill_chunk_tokens
            chunk = cfg.leoam.chunk_size
            if C % chunk or ecfg.max_len % C:
                raise ValueError(
                    f"prefix_cache admissions run chunked prefill: "
                    f"prefill_chunk_tokens={C} must be a multiple of the "
                    f"store chunk ({chunk}) and divide max_len "
                    f"({ecfg.max_len})")
        if not any(k.startswith("attn") for k in cfg.layer_kinds()):
            # the reference builds a store of zero layers and fails in it
            raise ValueError(
                f"BatchedLeoAMEngine tiers attention K/V; '{cfg.name}' has "
                f"no attention layer (its layers are "
                f"{sorted(set(cfg.layer_kinds()))}) — serve it with "
                f"lm.prefill and lm.decode_step")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}: build them on the engine's device")
        self.impl = impl
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.chunk = cfg.leoam.chunk_size
        self.n_chunks = ecfg.max_len // self.chunk
        self.max_seqs = max_seqs
        self.attn_layers = [i for i, k in enumerate(cfg.layer_kinds())
                            if k.startswith("attn")]
        self.recurrent = len(self.attn_layers) < cfg.n_layers
        # absorbed-MLA stacks tier ONE latent row per token through the
        # same store and selection machinery: the box over the
        # concatenated latent IS the MLA bound (q_lat.ckv + q_rope.krope
        # == q_cat.latent)
        self.mla = cfg.mla is not None
        kv_heads, kv_dim = (
            (1, cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) if self.mla
            else (cfg.n_kv_heads, cfg.hd))
        # the legacy device tier's budget is per store, the pool's per layer
        budget = (device_chunk_budget * len(self.attn_layers)
                  if device_chunk_budget is not None else None)
        self.store = TieredKVStore(
            len(self.attn_layers), self.n_chunks, self.chunk,
            kv_heads, kv_dim, n_seqs=max_seqs,
            transit_codec=ecfg.transit_codec, root=store_root,
            device_budget=budget, use_pool=ecfg.pooled,
            pool_slots=device_chunk_budget, real_codec=ecfg.real_codec,
            disk_sidecar=ecfg.disk_sidecar,
            sidecar_lossless=ecfg.sidecar_lossless, latent=self.mla,
            prefix_rows=(max(1, ecfg.prefix_arena_rows)
                         if ecfg.prefix_cache else 0),
            debug_sync=ecfg.debug_sync, checksums=ecfg.checksums,
            faults=ecfg.fault_plan, io_retries=ecfg.io_retries,
            io_backoff_s=ecfg.io_backoff_s,
            abstract_kind=("pq" if ecfg.pq_abstracts else "minmax"),
            pq_m=ecfg.pq_m, pq_centroids=ecfg.pq_centroids,
            pq_train_iters=ecfg.pq_train_iters, device=self.device, impl=impl,
            fidelity_dtype=torch_dtype(cfg.dtype))
        self.seqs: Dict[int, _SeqState] = {}
        # preempted sequences (suspend_sequence): their slot stays reserved
        self.suspended: Dict[int, _SeqState] = {}
        self._free: List[int] = list(range(max_seqs - 1, -1, -1))
        # DTP state: prefetch executor, per-(seq, layer) previous-round
        # selections, per-layer abstract cache, per-layer measured costs;
        # write-behind ingest rides the same worker
        self._executor = _prefetch_executor() if ecfg.pipeline else None
        self._ingest_exec = (_prefetch_executor() if ecfg.overlap_ingest
                             else None)
        self._pf_futs: Dict[int, Future] = {}
        self._abs_cache: Dict[int, Tuple] = {}
        self._prev_sels: Dict[Tuple[int, int], List[int]] = {}
        self._lcost: Dict[int, Dict[str, float]] = {}
        self.round_profiles: List[Dict[str, float]] = []
        # the running round's clock, which evaluate adds its parts to
        self._laps = Laps(dict.fromkeys(ROUND_KEYS, 0.0))
        self._on_round = None
        self.admit_profiles: List[Dict[str, float]] = []
        # the distinct prefill shapes run so far: padded whole-prompt
        # lengths and chunk-step sizes (the reference's compiled programs)
        self._prefill_shapes: set = set()
        self._chunk_prefill_shapes: set = set()
        self.failed: Dict[int, str] = {}
        self.seqs_failed = 0
        self.ingest_errors = 0
        # logits behind the last token the decode thread handed out
        # (add_sequence or a chunked admission's last step: (V,); decode
        # round: (B, V) in sorted seq-id order) — for end-to-end checks.
        # Only the decode thread writes it: an async admission's logits
        # stay in its sequence's ``prefill_logits``
        self.last_logits: Optional[np.ndarray] = None
        # the admission worker's CUDA stream (made at its first use)
        self._admit_stream: Optional[torch.cuda.Stream] = None

    @property
    def on_round(self):
        """Called with a :class:`RoundRecord` at the end of every decode
        round, or None (the default).  Set it before the first admission:
        the pools keep their int4 record only while it is set."""
        return self._on_round

    @on_round.setter
    def on_round(self, fn) -> None:
        self._on_round = fn
        for pool in self.store.pools:
            if pool is not None:
                pool.int4 = None if fn is None else {}

    @property
    def free_slots(self) -> int:
        """Sequence slots available for admission (scheduler-facing)."""
        return len(self._free)

    # ------------------------------------------------------------------
    # Sequence lifecycle
    # ------------------------------------------------------------------
    @decode_thread_only
    def add_sequence(self, tokens: np.ndarray) -> Tuple[int, int]:
        """Prefill one request into a free store slot; returns (seq id,
        first token).  Each attention layer's K/V is handed to the store
        as it comes off the device, with the replica + abstract writes
        write-behind on the prefetch worker; ``decode_round`` and
        ``release`` fence them before any read."""
        self._check_capacity()
        self._check_prompt(tokens)     # validate BEFORE taking the slot
        sid = self._free.pop()
        self.failed.pop(sid, None)
        try:
            with span("leoam.admit"):
                out = self._admit(sid, tokens, pool_place=True)
        except BaseException:
            self.abort_admission(sid)
            raise
        self.last_logits = self.seqs[sid].prefill_logits
        return out

    @decode_thread_only
    def add_sequence_async(self, tokens: np.ndarray) -> Future:
        """Admission under decode: reserve a slot NOW and run the prefill
        and ingest on the process-wide admission worker (``leoam-admit``),
        overlapped with the batch's decode rounds; only the store's locked
        sections serialize.  Device placements are deferred (the decode
        thread alone writes the pool slab); the next decode round folds
        them in — residency only, token streams are unchanged.  On the
        card the worker runs on its own CUDA stream, so its kernels can
        overlap the decode thread's.  Returns a Future of (seq id, first
        token); the sequence may join a decode round once it resolves.  A
        failure resolves it with :class:`AdmissionError` naming the slot,
        which the caller reclaims with :meth:`abort_admission`."""
        self._check_capacity()
        self._check_prompt(tokens)     # validate BEFORE taking the slot
        sid = self._free.pop()
        self.failed.pop(sid, None)
        if self.device.type == "cuda":
            if self._admit_stream is None:
                self._admit_stream = torch.cuda.Stream(self.device)
            # the worker's kernels start after everything this thread has
            # queued so far (the weights' writes included)
            self._admit_stream.wait_stream(
                torch.cuda.current_stream(self.device))
        return _admit_executor().submit(self._admit_guarded, sid, tokens)

    @worker_thread
    def _admit_guarded(self, sid: int, tokens: np.ndarray
                       ) -> Tuple[int, int]:
        """Admission-worker body: the whole admission on the worker's CUDA
        stream, its K/V and logits on the host before it returns.  Any
        failure surfaces as :class:`AdmissionError` carrying the slot id —
        the worker never touches the free list (the decode thread owns
        slot recycling)."""
        stream = torch.cuda.stream(self._admit_stream) \
            if self._admit_stream is not None else contextlib.nullcontext()
        try:
            with stream, span("leoam.admit"):
                return self._admit(sid, tokens, pool_place=False)
        except BaseException as e:
            raise AdmissionError(sid, e) from e

    def _check_capacity(self) -> None:
        if not self._free:
            raise ValueError(
                f"engine is at max_seqs={self.max_seqs} capacity — release "
                f"a sequence first, or rebuild the engine with a larger "
                f"max_seqs (the scheduler gates on engine.free_slots)")

    def _check_prompt(self, tokens: np.ndarray) -> None:
        S = len(tokens)
        if S >= self.ecfg.max_len:
            raise ValueError(
                f"prompt length {S} needs < max_len={self.ecfg.max_len} "
                f"(decode appends past the prompt); raise EngineCfg.max_len "
                f"or truncate the prompt")

    @worker_thread
    def _admit(self, sid: int, tokens: np.ndarray, *,
               pool_place: bool) -> Tuple[int, int]:
        """Whole-prompt admission into slot ``sid``, on the decode thread
        (``pool_place=True``) or the admission worker (``False``: device
        placements deferred).  With the prefix cache it is a chunked
        admission run to its end: only that can skip a warm span."""
        if self.ecfg.prefix_cache:
            adm = ChunkedAdmission(self, sid, np.asarray(tokens),
                                   self.ecfg.prefill_chunk_tokens,
                                   pool_place=pool_place)
            while not adm.done:
                adm._step_impl()
            return adm.result
        S = len(tokens)
        t0 = time.perf_counter()
        logits, cache = self._prefill(np.asarray(tokens))
        placement = self._default_placement()
        ingest_s = 0.0
        if self._ingest_exec is None:
            # serial: the whole prefill on the host first, then every
            # layer's replicas written inline
            kvs = [self._layer_kv(cache, layer) for layer in self.attn_layers]
            prefill_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            for li, layer in enumerate(self.attn_layers):
                k, v = kvs[li]
                with span("leoam.ingest"):
                    self.store.ingest(li, k[0], v[0],
                                      self._layer_placement(layer, placement),
                                      seq=sid, pool_place=pool_place)
            del kvs
            ingest_s = time.perf_counter() - t1
        else:
            # layer-streamed: hand each layer off as it reaches the host;
            # the replica/abstract writes go write-behind on the executor
            for li, layer in enumerate(self.attn_layers):
                k, v = self._layer_kv(cache, layer)
                t1 = time.perf_counter()
                with span("leoam.ingest"):
                    self.store.ingest(li, k[0], v[0],
                                      self._layer_placement(layer, placement),
                                      seq=sid, executor=self._ingest_exec,
                                      pool_place=pool_place)
                ingest_s += time.perf_counter() - t1
            prefill_s = time.perf_counter() - t0 - ingest_s
        state = self._recurrent_state(cache)
        first = _to_host(logits)[0]
        self.seqs[sid] = _SeqState(length=S,
                                   access=AccessTable(self.n_chunks),
                                   state=state, prefill_logits=first,
                                   tokens=np.asarray(tokens), prompt_len=S)
        self.admit_profiles.append({
            "total_s": time.perf_counter() - t0, "prefill_s": prefill_s,
            "ingest_s": ingest_s,
            "overlapped": float(self._ingest_exec is not None)})
        return sid, int(np.argmax(first))

    def _default_placement(self) -> Dict[int, str]:
        """Admission tier placement by chunk index (device head, host
        middle, disk tail)."""
        ecfg = self.ecfg
        n_gpu = max(1, int(self.n_chunks * ecfg.gpu_chunk_frac))
        n_cpu = max(1, int(self.n_chunks * ecfg.cpu_chunk_frac))
        return {c: DEVICE if c < n_gpu else
                (HOST if c < n_gpu + n_cpu else DISK)
                for c in range(self.n_chunks)}

    def _bucket_len(self, S: int) -> int:
        """Smallest bucket >= S: powers of two from 16, or the configured
        ``prefill_buckets`` schedule, capped at max_len (the cache pad)."""
        sched = self.ecfg.prefill_buckets
        if sched:
            for b in sorted(sched):
                if b >= S:
                    return min(int(b), self.ecfg.max_len)
            return self.ecfg.max_len
        b = 16
        while b < S:
            b <<= 1
        return min(b, self.ecfg.max_len)

    @property
    def prefill_programs(self) -> int:
        """Distinct prefill shapes run so far: padded whole-prompt lengths
        plus chunk-step sizes — the reference's count of compiled prefill
        programs (one per shape), which stays O(log max_len) under
        ``bucket_prefill`` for any mix of prompt lengths."""
        return len(self._prefill_shapes) + len(self._chunk_prefill_shapes)

    def _prefill(self, tokens: np.ndarray):
        """Model prefill on the engine's device.  With ``bucket_prefill``
        the prompt is right-padded to its length bucket and the true
        length rides along (logits row and cache zeroing honor it) —
        token-identical to exact-length prefill, as in the reference."""
        S = len(tokens)
        if self.ecfg.bucket_prefill:
            padded = np.zeros(self._bucket_len(S), np.int64)
            padded[:S] = tokens
            batch = {"tokens": torch.from_numpy(padded[None]).to(self.device),
                     "length": S}
        else:
            batch = {"tokens": torch.from_numpy(
                np.asarray(tokens, np.int64)[None]).to(self.device)}
        self._prefill_shapes.add(batch["tokens"].shape[1])
        with torch.no_grad(), span("leoam.prefill"):
            return lm.prefill(self.params, self.cfg, batch,
                              max_len=self.ecfg.max_len)

    def _prefill_chunk(self, batch: Dict[str, Any], cache):
        """One chunked-prefill step over ``cache`` (updated in place);
        each chunk size is one prefill shape."""
        self._chunk_prefill_shapes.add(batch["tokens"].shape[1])
        with torch.no_grad(), span("leoam.prefill"):
            return lm.prefill_chunk(self.params, self.cfg, batch, cache,
                                    max_len=self.ecfg.max_len)

    @decode_thread_only
    def begin_admission(self, tokens: np.ndarray) -> "ChunkedAdmission":
        """Start a CHUNKED admission: reserve the slot now and return a
        :class:`ChunkedAdmission` whose ``step()`` prefills one chunk of
        ``EngineCfg.prefill_chunk_tokens`` and streams its K/V into the
        store, so the caller can run decode rounds between chunks.
        Stepped on the decode thread, which places device chunks into the
        pool at once."""
        C = self.ecfg.prefill_chunk_tokens
        if C % self.chunk or self.ecfg.max_len % C:
            raise ValueError(
                f"prefill chunk_tokens={C} must be a multiple of the store "
                f"chunk ({self.chunk}) and divide max_len "
                f"({self.ecfg.max_len}) so partial ingests stay "
                f"chunk-aligned")
        self._check_capacity()
        self._check_prompt(tokens)     # validate BEFORE taking the slot
        sid = self._free.pop()
        self.failed.pop(sid, None)
        return ChunkedAdmission(self, sid, tokens, C)

    def _recurrent_state(self, cache) -> Optional[Dict[str, Any]]:
        """The recurrent layers' leaves of a prefill cache (its K/V go to
        the store): what :attr:`_SeqState.state` holds.  A state made on
        the admission worker's stream is marked as used by the decode
        thread's, so its memory is not reused before that stream is done
        with it."""
        if not self.recurrent:
            return None
        prologue, period, _ = lm._layer_plan(self.cfg)
        state = {"prologue": [None if k.startswith("attn")
                              else cache["prologue"][i]
                              for i, (_, k, _m) in enumerate(prologue)],
                 "body": [None if k.startswith("attn") else cache["body"][pi]
                          for pi, (k, _m) in enumerate(period)]}
        if self.device.type == "cuda" and \
                torch.cuda.current_stream(self.device) != \
                torch.cuda.default_stream(self.device):
            for part in state.values():
                for leaves in part:
                    for t in (leaves or {}).values():
                        t.record_stream(torch.cuda.default_stream(self.device))
        return state

    def _layer_cache(self, cache, layer: int) -> Dict[str, torch.Tensor]:
        pro_n = len(cache["prologue"])
        if layer < pro_n:
            return cache["prologue"][layer]
        period = self.cfg.period()
        bi = (layer - pro_n) // period
        pi = (layer - pro_n) % period
        return {k: v[bi] for k, v in cache["body"][pi].items()}

    def _layer_kv(self, cache, layer: int) -> Tuple[np.ndarray, np.ndarray]:
        """(k, v) (B, S, Hkv, hd) of one layer, on the host.  An MLA layer
        yields its latent rows (B, S, 1, r + rope) in both positions (the
        store keeps one latent plane).  The copies wait for the prefill's
        kernels: the span is the prefill's."""
        c = self._layer_cache(cache, layer)
        with span("leoam.prefill"):
            if self.mla:
                lat = _to_host(torch.cat([c["ckv"], c["krope"]], dim=-1))
                lat = lat[:, :, None, :]
                return lat, lat
            return _to_host(c["k"]), _to_host(c["v"])

    def _layer_kv_slice(self, cache, layer: int, start: int, n: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows [start, start + n) of one layer's (k, v), batch row 0, on
        the host: a chunked admission's stream-out (latent rows in both
        positions for MLA), under the prefill's span as in
        :meth:`_layer_kv`."""
        c = self._layer_cache(cache, layer)
        with span("leoam.prefill"):
            if self.mla:
                lat = _to_host(torch.cat([c["ckv"][0, start:start + n],
                                          c["krope"][0, start:start + n]],
                                         dim=-1))[:, None, :]
                return lat, lat
            return (_to_host(c["k"][0, start:start + n]),
                    _to_host(c["v"][0, start:start + n]))

    def _layer_placement(self, layer: int,
                         placement: Dict[int, str]) -> Dict[int, str]:
        if layer < self.cfg.leoam.early_layers:
            # early layers never go to disk (§4.3)
            return {c: (DEVICE if placement[c] == DEVICE else HOST)
                    for c in placement}
        return dict(placement)

    def _forget(self, sid: int) -> None:
        """Drop every per-sequence record (a suspended sequence's parked
        state too) and recycle the slot."""
        self.store.clear_seq(sid)
        self.seqs.pop(sid, None)
        self.suspended.pop(sid, None)
        for key in [k for k in self._prev_sels if k[0] == sid]:
            self._prev_sels.pop(key, None)
        if sid not in self._free:
            self._free.append(sid)

    @decode_thread_only
    def release(self, sid: int) -> None:
        """Retire a sequence and recycle its store slot, after draining
        every in-flight future that may still reference the slot (its
        write-behind ingest, the prefetch worker's staged reads and the
        queued repacks, which then land instead of being aborted)."""
        self._drain_seq(sid)
        self._abs_cache.clear()
        self._forget(sid)

    def _drain_seq(self, sid: int) -> None:
        """Best-effort drain of the slot's in-flight futures (ingest fence,
        prefetch worker, repack queue); failures are counted, never
        raised, so every teardown runs to completion."""
        try:
            self.store.ingest_fence(sid)
        except Exception:
            self.ingest_errors += 1
        for li in list(self._pf_futs):
            fut = self._pf_futs.pop(li, None)
            if fut is not None:
                try:
                    fut.result()
                except Exception:
                    pass
        try:
            self.store.requant_fence()
        except Exception:
            pass

    @decode_thread_only
    def abort_admission(self, sid: int) -> None:
        """Reclaim a slot whose admission failed mid-flight.  Idempotent."""
        self._drain_seq(sid)
        self._forget(sid)

    @decode_thread_only
    def fail_sequence(self, sid: int, reason: str) -> None:
        """Contain ONE sequence's failure as its terminal state."""
        self._drain_seq(sid)
        self._abs_cache.clear()
        self._forget(sid)
        self.failed[sid] = reason
        self.seqs_failed += 1

    # ------------------------------------------------------------------
    # Whole-sequence preemption (overload control)
    # ------------------------------------------------------------------
    @decode_thread_only
    def suspend_sequence(self, sid: int) -> None:
        """Preempt ONE live sequence: fence its write-behind ingest, drop
        its speculative prefetch state, swap its whole hot working set
        down to the disk tier (pool slots and host copies released —
        :meth:`TieredKVStore.swap_out_seq`) and park its decode state in
        :attr:`suspended`.

        The slot stays reserved (the sequence's only full replica lives in
        that store row), so preemption relieves pool slots, host bytes and
        the scheduler's batch seat, never ``free_slots``.  The host-side
        state and the store's access, abstract and CRC state are kept, and
        the write-through replica holds every appended row, so suspend +
        resume is the identity on the token stream."""
        if sid not in self.seqs:
            raise KeyError(f"suspend_sequence: seq {sid} is not live "
                           f"(live={sorted(self.seqs)})")
        self._drain_seq(sid)
        self._abs_cache.clear()
        for key in [k for k in self._prev_sels if k[0] == sid]:
            self._prev_sels.pop(key, None)
        st = self.seqs.pop(sid)
        self.store.swap_out_seq(sid)
        self.suspended[sid] = st

    @decode_thread_only
    def resume_sequence(self, sid: int) -> None:
        """Un-park a suspended sequence: re-stage its remembered working
        set on the host off the disk replica (``swap_in_seq``; a chunk
        that fails verification takes the usual disk-lost recovery at its
        next fetch) and rejoin the live set."""
        st = self.suspended.pop(sid, None)
        if st is None:
            raise KeyError(f"resume_sequence: seq {sid} is not suspended "
                           f"(suspended={sorted(self.suspended)})")
        self.store.swap_in_seq(sid)
        self.seqs[sid] = st

    def fault_stats(self) -> Dict[str, float]:
        out = self.store.fault_stats()
        out["seqs_failed"] = float(self.seqs_failed)
        out["ingest_errors"] = float(self.ingest_errors)
        return out

    def pool_stats(self) -> Dict[str, float]:
        """Live device-pool occupancy/hit counters (scheduler-facing)."""
        return self.store.pool_stats()

    def admission_need_chunks(self, prompt_len: int, max_new: int) -> int:
        """Worst-case per-round device working set of one request, in pool
        slots per layer — what pool-aware admission charges."""
        cfg, ecfg = self.cfg, self.ecfg
        L = min(prompt_len + max_new, ecfg.max_len)
        nv = -(-L // self.chunk)
        rate = max(cfg.leoam.importance_rate, cfg.leoam.early_rate)
        sel = -(-max(self.chunk, math.ceil(L * rate)) // self.chunk)
        forced = (cfg.leoam.sink_chunks + cfg.leoam.recent_chunks
                  + math.ceil(ecfg.hot_frac * nv))
        return min(nv, sel + forced)

    # ------------------------------------------------------------------
    # DTP: measured-cost θ balance + speculative prefetch
    # ------------------------------------------------------------------
    def _theta(self, li: int) -> float:
        """Per-layer compressed fraction of the upload delta (§4.4): the
        smallest θ hiding the transfer under the measured compute window."""
        if not (self.ecfg.real_codec and self.ecfg.transit_codec):
            return 1.0
        lc = self._lcost.get(li)
        if lc is None:
            return 1.0                 # no measurement yet: compress all
        bw = dtp.TierBW(pcie=self.ecfg.pcie_bw, disk=self.ecfg.disk_bw,
                        kappa=self.ecfg.kappa,
                        delta=compression.codec_ratio(self.ecfg.transit_codec,
                                                      group=self.chunk))
        return dtp.theta_from_measured(lc["D"], lc["T0"], lc["Tc"], bw)

    def _sync_stream(self) -> None:
        """Wait for the work queued on the engine's CUDA stream (``profile``
        only; nothing on the CPU, where every op has run on return)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _update_costs(self, li: int, upload_bytes: float, disk_bytes: float,
                      compute_s: float) -> None:
        """EMA of the layer's measured round costs (the compute window is
        the measured attend time with ``profile``, (round − host
        stages)/n_attn without)."""
        lc = self._lcost.setdefault(li, {"D": upload_bytes, "T0": disk_bytes,
                                         "Tc": max(compute_s, 1e-7)})
        for k, v in (("D", upload_bytes), ("T0", disk_bytes),
                     ("Tc", max(compute_s, 1e-7))):
            lc[k] = 0.5 * lc[k] + 0.5 * v

    def _submit_prefetch(self, li: int, order: Sequence[int],
                         lengths: np.ndarray) -> None:
        """Overlap layer ``li``'s abstract reads + speculative disk staging
        under the previous layer's attention.  Predictions come from the
        previous round's selection, else the AccessTable hot set —
        residency-only.  Skipped when nothing predicted sits on disk."""
        if self._executor is None or li >= len(self.attn_layers) \
                or li in self._pf_futs:
            return
        chunks_by_seq = {}
        pred = {}
        any_disk = False
        for i, sid in enumerate(order):
            nv = (int(lengths[i]) + self.chunk - 1) // self.chunk
            chunks_by_seq[sid] = list(range(nv))
            prev = self._prev_sels.get((sid, li))
            if prev is None:
                prev = [int(c) for c in
                        self.seqs[sid].access.hot_tokens(self.ecfg.hot_frac)]
            pred[sid] = [c for c in prev if c < nv]
            tiers = self.store.tier_view(sid, li) \
                if self.ecfg.prefix_cache else self.store.tier[sid, li]
            if not any_disk and any(tiers[c] == DISK for c in pred[sid]):
                any_disk = True
        if not any_disk:
            return
        key = tuple((sid, len(chunks_by_seq[sid])) for sid in order)

        @worker_thread
        def work():
            with span("leoam.prefetch"):
                res = self._read_abstracts(li, chunks_by_seq)
                self._abs_cache[li] = (key, res)
                self.store.stage_host(li, pred)

        self._pf_futs[li] = self._executor.submit(work)

    # ------------------------------------------------------------------
    # Importance evaluation (batched LKA + per-sequence IAKM)
    # ------------------------------------------------------------------
    def _read_abstracts(self, li: int, chunks_by_seq: Dict[int, List[int]]):
        """The layer's abstracts: min/max boxes, plus the PQ codes, their
        validity and the codebook when ``pq_abstracts`` is on."""
        if self.ecfg.pq_abstracts:
            return self.store.read_abstracts_pq_batch(li, chunks_by_seq)
        return self.store.read_abstracts_batch(li, chunks_by_seq)

    def _select_chunks_batched(self, li: int, layer: int, q: torch.Tensor,
                               order: Sequence[int], lengths: np.ndarray
                               ) -> Tuple[Dict[int, List[int]],
                                          Dict[int, StepStats]]:
        """One bounds product over the stacked batch (kernel B1 on the
        card, its latent variant for MLA), with ADC scores off the PQ codes
        for code-valid chunks when ``pq_abstracts`` is on, then
        per-sequence chunk-level adaptive selection on the host.  q: (B,
        H, d) PRE-SCALED queries, rows matching ``order`` — GQA passes
        q/sqrt(hd) against the per-head key boxes, MLA concat(q_lat,
        q_rope)·scale against the latent boxes (one kv head).

        Its parts add to the running round's clock from the caller's last
        lap: ``eval_wait_s`` (the prefetch worker's future, where there
        is one), ``eval_read_s`` (the call itself and the abstracts; a
        read of its own on a speculation miss, counted in
        ``spec_misses``), ``eval_bounds_s`` (their upload, the bounds
        product and its copy back); the caller laps ``eval_select_s``
        (the per-sequence selection) on its return."""
        cfg = self.cfg
        chunk = self.chunk
        laps = self._laps
        fut = self._pf_futs.pop(li, None)
        if fut is not None:
            laps.lap("eval_read_s")
            with span("leoam.eval_wait"):
                fut.result()
            laps.lap("eval_wait_s")
        with span("leoam.eval_read"):
            n_valid = {sid: (int(L) + chunk - 1) // chunk
                       for sid, L in zip(order, lengths)}
            chunks_by_seq = {sid: list(range(n_valid[sid])) for sid in order}
            use_pq = self.ecfg.pq_abstracts
            cached = self._abs_cache.pop(li, None)
            key = tuple((sid, n_valid[sid]) for sid in order)
            if cached is not None and cached[0] == key:
                res = cached[1]
            else:   # speculation miss: sync read (the worker's stays billed)
                res = self._read_abstracts(li, chunks_by_seq)
                laps.prof["spec_misses"] += 1
        laps.lap("eval_read_s")
        with span("leoam.eval_bounds"):
            if use_pq:
                km, kn, pq_codes, pq_valid, pq_cb, abs_billed = res
            else:
                km, kn, abs_billed = res
            bounds = chunk_bounds_latent if self.mla \
                else chunk_bounds_gqa_matmul
            ub, _ = bounds(q, torch.from_numpy(km).to(q.device),
                           torch.from_numpy(kn).to(q.device), impl=self.impl)
            ub = ub.cpu().numpy()                            # (B, Hkv, ncmax)
            adc = None
            if use_pq and pq_valid.any():
                # asymmetric-distance scores off the PQ codes: q summed per
                # kv group against decoded centroids, max over a chunk's
                # live tokens.  Only code-valid chunks use them; the rest
                # keep the min/max upper bound BITWISE (np.where selects
                # whole values)
                adc = adc_chunk_scores(group_sum(q, km.shape[2]), pq_cb,
                                       pq_codes, lengths).cpu().numpy()
        laps.lap("eval_bounds_s")

        rate = (cfg.leoam.early_rate if layer < cfg.leoam.early_layers
                else cfg.leoam.importance_rate)
        sels: Dict[int, List[int]] = {}
        stats: Dict[int, StepStats] = {}
        with span("leoam.eval_select"):
            for i, sid in enumerate(order):
                st = StepStats(abstract_bytes=abs_billed[sid])
                nv = n_valid[sid]
                length = int(lengths[i])
                scores = ub[i].max(0)[:nv]                   # (nv,)
                if adc is not None:
                    scores = np.where(pq_valid[i, :nv], adc[i].max(0)[:nv],
                                      scores)
                budget_tokens = max(chunk, int(math.ceil(length * rate)))
                chunk_scores = scores / chunk
                if self.ecfg.selection == "tree":
                    sel, st.evaluations = tree_select_chunks(
                        chunk_scores, length, budget_tokens, chunk)
                else:
                    sel, st.evaluations = flat_select_chunks(
                        chunk_scores, length, budget_tokens, chunk)
                # sink + recent + hot chunks always included
                forced = set(range(cfg.leoam.sink_chunks))
                forced.update(range(max(0, nv - cfg.leoam.recent_chunks),
                                    nv))
                forced.update(
                    int(c) for c in self.seqs[sid].access.hot_tokens(
                        self.ecfg.hot_frac) if c < nv)
                sels[sid] = sorted(set(sel) | forced)
                stats[sid] = st
        return sels, stats

    # ------------------------------------------------------------------
    # Decode round
    # ------------------------------------------------------------------
    # decode_round allows this many ChunkLostError recoveries: each one
    # restores chunks or removes a sequence, so reaching the bound means a
    # fault injector scheduling back-to-back losses
    _MAX_ROUND_RETRIES = 8

    @decode_thread_only
    def decode_round(self, tokens: Dict[int, int]) -> Dict[int, int]:
        """One token for every sequence in ``tokens`` ({seq id: last
        token}); returns {seq id: next token}.

        A failure on one sequence never takes the batch down.  A sequence
        whose write-behind ingest failed is failed alone (its reason lands
        in :attr:`failed`).  A disk-lost chunk (:class:`ChunkLostError`)
        rolls the round's selection state back and recomputes exactly the
        lost span from the prompt when it lies inside the prompt, else
        fails the owning sequence; the round then re-runs with the
        survivors.  Returns {} when every sequence failed."""
        if not tokens:
            raise ValueError(
                "decode_round needs at least one sequence: pass "
                "{seq id: last token} for every live sequence (admit one "
                "via add_sequence first)")
        with span("leoam.round"):
            live = dict(tokens)
            for sid in sorted(live):        # write-behind completion fence
                try:
                    self.store.ingest_fence(sid)
                except Exception as e:
                    self.ingest_errors += 1
                    self.fail_sequence(sid, f"cold ingest failed: {e!r}")
                    live.pop(sid)
            for _ in range(self._MAX_ROUND_RETRIES):
                if not live:
                    return {}
                snap = self._snapshot_round(live)
                try:
                    with torch.no_grad():
                        return self._decode_round_impl(live)
                except ChunkLostError as e:
                    self._restore_round(snap)
                    self._recover_lost(e, live)
        raise RuntimeError(
            f"decode round failed to converge after "
            f"{self._MAX_ROUND_RETRIES} chunk-loss recoveries — the disk "
            f"is losing chunks faster than recompute restores them")

    def _snapshot_round(self, live: Dict[int, int]) -> Dict[str, Any]:
        """The host-side state a partial round mutates before a fetch can
        raise, so a retry re-runs from a clean slate.  Residency and
        billing need no rollback: residency moves bytes, never values, and
        a retried read honestly re-bills."""
        return {"access": {sid: self.seqs[sid].access.counts.copy()
                           for sid in live},
                "prev_sels": dict(self._prev_sels)}

    def _restore_round(self, snap: Dict[str, Any]) -> None:
        """Roll back the selection state a failed round half-mutated and
        drain its speculative prefetch: a future may hold stale layer
        predictions (or the same ChunkLostError), and one left running
        would race the retried round's reads."""
        for sid, counts in snap["access"].items():
            if sid in self.seqs:
                self.seqs[sid].access.counts[:] = counts
        self._prev_sels.clear()
        self._prev_sels.update(snap["prev_sels"])
        for li in list(self._pf_futs):
            fut = self._pf_futs.pop(li, None)
            if fut is not None:
                try:
                    fut.result()
                except Exception:
                    pass
        self._abs_cache.clear()

    def _recover_lost(self, e: ChunkLostError, live: Dict[int, int]) -> None:
        """Handle one ChunkLostError: recompute every affected sequence
        whose lost chunks all lie inside its prompt span; fail the rest.
        Recompute covers every chunk the store marks lost for the sequence
        (a speculative prefetch may have found more than this gather did):
        one prefill replay restores the whole set."""
        by_seq: Dict[int, set] = {}
        for seq, _p, c in e.keys:
            by_seq.setdefault(seq, set()).add(c)
        lost_all = self.store.disk_lost_keys()
        for sid, cs in by_seq.items():
            if sid not in live:
                continue
            cs = cs | {c for (p, _li, c) in lost_all
                       if self.store._phys(sid, c) == p}
            s = self.seqs.get(sid)
            recomputable = (
                s is not None and s.tokens is not None
                and all(min((c + 1) * self.chunk, s.length) <= s.prompt_len
                        for c in cs))
            if not recomputable:
                # the lost span holds decode appends: that K/V exists
                # nowhere else — terminal for this sequence alone
                self.fail_sequence(
                    sid, f"disk-lost chunks {sorted(cs)} at layer "
                         f"{e.layer} not recomputable from prompt")
                live.pop(sid)
                continue
            self._recompute_chunks(sid, cs)

    def _recompute_chunks(self, sid: int, cs) -> None:
        """Recompute-from-prompt for one sequence's disk-lost prompt-span
        chunks: replay chunked prefill (``prefill_chunk_tokens`` a step,
        from a zeroed decode cache) through the last lost chunk and re-land
        every (layer, chunk) the store still marks lost through
        :meth:`TieredKVStore.restore_chunk` — replica, abstracts and CRC
        rebuilt; the quarantined sidecar repacks lazily.  In f32 the replay
        stores the admission's bytes; in bf16 on the card it does so for a
        sequence admitted chunked with the same step, while a whole-prompt
        admission's GEMM shapes differ (ROADMAP C8)."""
        s = self.seqs[sid]
        toks = np.asarray(s.tokens)
        C = self.ecfg.prefill_chunk_tokens
        end = min(len(toks), (max(cs) + 1) * self.chunk)
        end = min(-(-end // C) * C, self.ecfg.max_len)
        cache = lm.init_decode_cache(self.cfg, 1, self.ecfg.max_len,
                                     device=self.device)
        pos = 0
        while pos < end:
            chunk_toks = np.zeros(C, np.int64)
            take = min(C, len(toks) - pos)
            if take > 0:
                chunk_toks[:take] = toks[pos:pos + take]
            batch = {"tokens": torch.from_numpy(
                chunk_toks[None]).to(self.device),
                     "start": pos, "length": len(toks)}
            _, cache = self._prefill_chunk(batch, cache)
            pos += C
        lost_now = self.store.disk_lost_keys()
        for li, layer in enumerate(self.attn_layers):
            for c in sorted(set(cs)):
                if (self.store._phys(sid, c), li, c) not in lost_now:
                    continue
                k, v = self._layer_kv_slice(cache, layer, c * self.chunk,
                                            self.chunk)
                self.store.restore_chunk(li, sid, c, k, v)

    @decode_thread_only
    def _decode_round_impl(self, tokens: Dict[int, int]) -> Dict[int, int]:
        cfg, ecfg = self.cfg, self.ecfg
        dev = self.device
        order = sorted(tokens)
        B = len(order)
        lengths = np.array([self.seqs[sid].length for sid in order],
                           np.int64)
        lengths_dev = torch.from_numpy(lengths.astype(np.int32)).to(dev)
        pos = lengths_dev[:, None]                               # (B, 1)
        if cfg.rope == "mrope":
            # every M-RoPE stream takes the token's position, as in
            # attention.gqa_decode (the reference's round passes the
            # (B, 1) positions as the three streams, ROADMAP C15)
            pos = pos[None].expand(3, B, 1)
        x = torch.tensor([[tokens[sid]] for sid in order], dtype=torch.long,
                         device=dev)
        params = self.params
        h = params["embed"][x]                                   # (B, 1, d)
        H, hd = cfg.n_heads, cfg.hd

        prologue, period, repeats = lm._layer_plan(cfg)
        round_stats = {sid: StepStats() for sid in order}
        prof = dict.fromkeys(ROUND_KEYS, 0.0)
        sync = self._sync_stream if ecfg.profile else None
        layer_io: List[Tuple[int, float, float]] = []  # (li, upB, diskB)
        # the public round record, only while someone reads it
        hook = self._on_round
        rec_len = dict(zip(order, lengths.tolist())) if hook else None
        rec_sels = {sid: {} for sid in order} if hook else None
        rec_int4: Dict[int, Dict[int, Dict[int, int]]] = {}
        lock_wait0 = self.store.lock_wait_s
        # the round's parts share end points; a stretch lapped with no key
        # is the round's self time
        laps = self._laps = Laps(prof)
        t_round = laps.t
        li = 0

        def run_attn(blk, mlpk, h, layer_idx):
            nonlocal li
            laps.lap()
            with span("leoam.dense"):
                hln = rms_norm(h, blk["ln1"], cfg.norm_eps)
                if self.mla:
                    # absorbed MLA: the query lives in latent space (q_lat
                    # = q_nope . W_UK, then q_rope) and the round's cache
                    # row is ONE latent vector; selection and attention
                    # both run over the store's latent plane
                    p = blk["core"]
                    sc = attn_mod.mla_scale(cfg)
                    q_nope, q_rope = attn_mod._mla_q(p, cfg, hln, pos)
                    q_lat = scale_like(torch.einsum(
                        "bhd,hrd->bhr", q_nope[:, 0], p["wk_b"]), sc)
                    qn = torch.cat([q_lat, scale_like(q_rope[:, 0], sc)],
                                   dim=-1)
                    ckv_new, krope_new = attn_mod.mla_latent(p, cfg, hln,
                                                             pos)
                    lat_new = torch.cat([ckv_new[:, 0], krope_new[:, 0]],
                                        dim=-1)
                else:
                    q, k_new, v_new = attn_mod._qkv(blk["core"], cfg, hln,
                                                    pos)
                    qn = q[:, 0] / math.sqrt(hd)                 # (B, H, hd)
            t_eval = laps.lap("dense_s")
            with span("leoam.evaluate"):
                sels, sel_stats = self._select_chunks_batched(
                    li, layer_idx, qn, order, lengths)
            prof["eval_s"] += laps.lap("eval_select_s") - t_eval

            nmax = max(len(s) for s in sels.values())
            pad = max(1, ecfg.sel_pad)
            nmax = -(-nmax // pad) * pad
            for sid in order:
                st = round_stats[sid]
                st.evaluations += sel_stats[sid].evaluations
                st.fetched_chunks += len(sels[sid])
                st.abstract_bytes += sel_stats[sid].abstract_bytes
                self.seqs[sid].access.record(np.asarray(sels[sid]))
                self._prev_sels[(sid, li)] = sels[sid]

            chunk_ids = np.full((B, nmax), -1, np.int32)
            for i, sid in enumerate(order):
                chunk_ids[i, :len(sels[sid])] = sels[sid]
            if ecfg.pooled:
                slots, _, fst = self.store.fetch_chunks_pooled(
                    li, sels, pad_to=nmax, theta=self._theta(li),
                    lengths=rec_len)
                prof["gather_s"] += fst.gather_s
                prof["upload_s"] += fst.upload_s
                layer_io.append((li, fst.uploads * self.store.chunk_bytes,
                                 fst.disk_bytes))
                if hook:
                    held = self.store.pools[li].int4
                    for i, sid in enumerate(order):
                        rec_sels[sid][li] = list(sels[sid])
                        h4 = {c: held[s] for c, s in zip(
                            sels[sid], slots[i].tolist()) if s in held}
                        if h4:
                            rec_int4.setdefault(sid, {})[li] = h4
                # overlap: next layer's reads under this layer's attention
                self._submit_prefetch(li + 1, order, lengths)
                laps.lap()
                with span("leoam.dense"):
                    cids_dev = torch.from_numpy(chunk_ids).to(dev)
                    slots_dev = torch.from_numpy(slots).to(dev)
                    pool_kv = self.store.pools[li].kv
                    if sync:
                        sync()
                    t1 = time.perf_counter()
                    if self.mla:
                        o = sparse_decode_latent_pooled(
                            qn, pool_kv, slots_dev, cids_dev, lengths_dev,
                            lat_new, cfg.mla.kv_lora_rank, impl=self.impl)
                    else:
                        o = sparse_decode_pooled(
                            q[:, 0], pool_kv, slots_dev, cids_dev,
                            lengths_dev, k_new, v_new, cfg.attn_softcap,
                            impl=self.impl)
            else:
                # the legacy path: the host-assembled working set crosses
                # whole every round and B2 reads it in place (one plane for
                # MLA: the latent stack sits in both positions)
                if hook:
                    for sid in order:
                        rec_sels[sid][li] = list(sels[sid])
                with span("leoam.fetch"):
                    laps.lap()
                    with span("leoam.gather"):
                        kg, vg, _ = self.store.fetch_chunks_batch(
                            li, sels, pad_to=nmax)
                    laps.lap("gather_s")
                    with span("leoam.upload"):
                        kgd = torch.from_numpy(kg).to(dev)
                        vgd = None if self.mla \
                            else torch.from_numpy(vg).to(dev)
                    laps.lap("upload_s")
                with span("leoam.dense"):
                    cids_dev = torch.from_numpy(chunk_ids).to(dev)
                    if sync:
                        sync()
                    t1 = time.perf_counter()
                    if self.mla:
                        o = sparse_decode_latent_workingset(
                            qn, kgd, cids_dev, lengths_dev, lat_new,
                            cfg.mla.kv_lora_rank, impl=self.impl)
                    else:
                        o = sparse_decode_workingset(
                            q[:, 0], kgd, vgd, cids_dev, lengths_dev,
                            k_new, v_new, cfg.attn_softcap, impl=self.impl)
            with span("leoam.dense"):
                if self.mla:
                    # the absorbed value projection W_UV in f32 on out_lat,
                    # then the output projection in the model dtype
                    o = torch.einsum("bhr,hrv->bhv", o,
                                     blk["core"]["wv_b"].float()
                                     ).to(q_lat.dtype)
                y = o.reshape(B, 1, -1) @ blk["core"]["wo"]
                if sync:
                    # attention through the output projection, as the
                    # reference's blocking profile times it
                    sync()
                    prof["attend_s"] += time.perf_counter() - t1
            laps.lap("dense_s")
            with span("leoam.append"):
                # the copies to the host wait for the layer's queued work
                with span("leoam.append_copy"):
                    if self.mla:
                        k_rows, v_rows = _to_host(lat_new)[:, None, :], None
                    else:
                        k_rows = _to_host(k_new[:, 0])
                        v_rows = _to_host(v_new[:, 0])
                laps.lap("append_copy_s")
                with span("leoam.append_store"):
                    self.store.append_tokens_batch(li, lengths, k_rows,
                                                   v_rows, seqs=order)
                laps.lap("append_store_s")
            li += 1
            with span("leoam.dense"):
                h = lm._apply_mlp(blk, cfg, mlpk, h + y)
            laps.lap("dense_s")
            return h

        states = [self.seqs[sid].state for sid in order]
        new_states: List[Tuple[str, int, Optional[int], dict]] = []

        def run_other(blk, kind, mlpk, h, layer_idx, part, pi, r):
            """A recurrent layer: one decode step over the sequences'
            states stacked on the batch axis (each row reads only its own
            state, as in the reference's per-sequence ``run_other``), into
            a copy that the round commits at its end."""
            laps.lap()
            with span("leoam.dense"):
                c = {name: torch.cat([st[part][pi][name] if r is None
                                      else st[part][pi][name][r]
                                      for st in states])
                     for name in states[0][part][pi]}
                # a recurrent layer reads no cache length
                h = lm._block_decode(blk, cfg, kind, mlpk, h, c, 0,
                                     layer_idx=layer_idx,
                                     ctx=attn_mod.LOCAL_CTX, impl=self.impl)
            laps.lap("dense_s")
            new_states.append((part, pi, r, c))
            return h

        for pi, (idx, kind, mlpk) in enumerate(prologue):
            blk = params["prologue"][pi]
            if kind.startswith("attn"):
                h = run_attn(blk, mlpk, h, idx)
            else:
                h = run_other(blk, kind, mlpk, h, idx, "prologue", pi, None)
        for r in range(repeats):
            for pi, (kind, mlpk) in enumerate(period):
                blk = lm.body_block(params, pi, r)
                if kind.startswith("attn"):
                    h = run_attn(blk, mlpk, h, 10 ** 6)
                else:
                    h = run_other(blk, kind, mlpk, h, 10 ** 6, "body", pi, r)

        laps.lap()
        with span("leoam.logits"):
            logits = _to_host(lm._logits(params, cfg, h)[:, 0])  # (B, V)
            nxt = [int(np.argmax(logits[i])) for i in range(B)]
        total_s = laps.lap("logits_s") - t_round
        self.last_logits = logits
        prof["total_s"] = total_s
        prof["lock_wait_s"] = self.store.lock_wait_s - lock_wait0
        if not ecfg.profile:
            # the rest of the round: attention, MLPs, appends (the window
            # the θ balance must hide transfers under — an upper bound, as
            # in the reference without its profile mode)
            prof["attend_s"] = max(0.0, total_s - prof["eval_s"]
                                   - prof["gather_s"] - prof["upload_s"])
        self.round_profiles.append(prof)
        # feed measured per-layer costs back into the θ balance
        tc = prof["attend_s"] / max(1, len(self.attn_layers))
        for lid, up_b, disk_b in layer_io:
            self._update_costs(lid, up_b, disk_b, tc)
        # the round ran to its end: commit the recurrent states (a body
        # layer's into its repeat's row of the stacked leaves)
        for part, pi, r, c in new_states:
            for i, st in enumerate(states):
                for name, t in st[part][pi].items():
                    (t if r is None else t[r]).copy_(c[name][i:i + 1])
        out: Dict[int, int] = {}
        for i, sid in enumerate(order):
            s = self.seqs[sid]
            s.length += 1
            s.stats.append(round_stats[sid])
            out[sid] = nxt[i]
        if ecfg.sidecar_requant and (ecfg.disk_sidecar or ecfg.pq_abstracts):
            # background repack of append-dirtied sidecars and re-encode of
            # their PQ codes (chunks quiet for a full round): long-running
            # sequences regain packed disk->host promotions and ADC scoring
            # instead of fp16 and the min/max box forever
            self.store.requant_sweep(executor=_prefetch_executor())
        if hook:
            hook(RoundRecord(order=order, lengths=rec_len,
                             selections=rec_sels, int4=rec_int4,
                             profile=prof))
        return out


class ChunkedAdmission:
    """Resumable chunked prefill of ONE request.

    Made by :meth:`BatchedLeoAMEngine.begin_admission`.  Each :meth:`step`
    prefills one fixed-size chunk over the decode cache (offset-causal
    attention, ``lm.prefill_chunk``) and streams the chunk's K/V into the
    store — hot placement at once, replica and abstract writes
    write-behind, as in whole-prompt admission — then returns, so decode
    rounds can run between a long prompt's chunks.  After the last prompt
    chunk the cache rows past it (zeros) are ingested too, so tiers,
    abstracts and replicas cover what whole-prompt admission covers.
    ``result`` is (seq id, first token) once ``done``.

    ``pool_place=False`` (the admission worker drives ``_step_impl``)
    defers device placements as ``add_sequence_async`` does.  With the
    prefix cache the admission first adopts the prompt's matched chunk
    span by reference, loads its rows into the cache and resumes at the
    cold suffix; the last prompt chunk is always recomputed (the first
    token needs its logits) and ingest drops its adopted chunks."""

    def __init__(self, engine: BatchedLeoAMEngine, sid: int,
                 tokens: np.ndarray, chunk_tokens: int, *,
                 pool_place: bool = True):
        self.engine = engine
        self.sid = sid
        self.tokens = np.asarray(tokens)
        self.S = len(self.tokens)
        self.C = int(chunk_tokens)
        self.pool_place = pool_place
        self.pos = 0
        self.cache = lm.init_decode_cache(engine.cfg, 1, engine.ecfg.max_len,
                                          device=engine.device)
        self.placement = engine._default_placement()
        self.result: Optional[Tuple[int, int]] = None
        self.cancelled = False
        self.n_steps = 0
        self._t0 = time.perf_counter()
        self._prefill_s = 0.0
        self._ingest_s = 0.0
        self._hit_tokens = 0
        if engine.ecfg.prefix_cache:
            hit = engine.store.prefix_admit(sid, self.tokens)
            self._hit_tokens = int(hit)
            resume = min((hit // self.C) * self.C,
                         ((self.S - 1) // self.C) * self.C)
            if resume > 0:
                rows = engine.store.prefix_fill_rows(sid, resume)
                self.cache = lm.load_prefix_rows(engine.cfg, self.cache,
                                                 rows, resume)
                self.pos = resume

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def remaining(self) -> int:
        """Prompt tokens still to prefill."""
        return max(0, self.S - self.pos)

    def _ingest_rows(self, li: int, layer: int, k: np.ndarray,
                     v: np.ndarray, start: int) -> None:
        eng = self.engine
        with span("leoam.ingest"):
            eng.store.ingest(li, k, v,
                             eng._layer_placement(layer, self.placement),
                             seq=self.sid, executor=eng._ingest_exec,
                             pool_place=self.pool_place, start=start)

    @decode_thread_only
    def step(self) -> int:
        """Advance one chunk; returns the prompt tokens it consumed (0 once
        done or cancelled)."""
        with span("leoam.admit"):
            return self._step_impl()

    @decode_thread_only
    def cancel(self) -> None:
        """Abandon a partial admission (deadline or client cancel): drain
        the write-behind futures of the chunks already streamed and
        release everything the slot holds via
        :meth:`BatchedLeoAMEngine.abort_admission`.  Later steps do
        nothing."""
        if self.done or self.cancelled:
            return
        self.cancelled = True
        self.cache = None
        self.engine.abort_admission(self.sid)

    def _step_impl(self) -> int:
        if self.done or self.cancelled:
            return 0
        eng, C = self.engine, self.C
        take = min(C, self.S - self.pos)
        t0 = time.perf_counter()
        chunk_toks = np.zeros(C, np.int64)
        chunk_toks[:take] = self.tokens[self.pos:self.pos + take]
        batch = {"tokens": torch.from_numpy(chunk_toks[None]).to(eng.device),
                 "start": self.pos, "length": self.S}
        logits, self.cache = eng._prefill_chunk(batch, self.cache)
        ingest_s = 0.0
        for li, layer in enumerate(eng.attn_layers):
            # the copy to the host waits for the chunk's kernels: prefill
            k, v = eng._layer_kv_slice(self.cache, layer, self.pos, C)
            t1 = time.perf_counter()
            self._ingest_rows(li, layer, k, v, self.pos)
            ingest_s += time.perf_counter() - t1
        self._prefill_s += time.perf_counter() - t0 - ingest_s
        self._ingest_s += ingest_s
        self.pos += take
        self.n_steps += 1
        if self.pos >= self.S:
            self._finish(logits)
        return take

    def _finish(self, logits: torch.Tensor) -> None:
        eng = self.engine
        end = -(-self.S // self.C) * self.C      # rows ingested so far
        tail = eng.ecfg.max_len - end
        if tail > 0:
            # zero-fill the chunks past the prompt: whole-prompt admission
            # ingests the whole max_len cache, and tier labels, abstracts
            # and the reused-slot scrub must match it
            t1 = time.perf_counter()
            zk = np.zeros((tail, eng.store.kv_heads, eng.store.head_dim),
                          eng.store.dtype)
            for li, layer in enumerate(eng.attn_layers):
                self._ingest_rows(li, layer, zk, zk, end)
            self._ingest_s += time.perf_counter() - t1
        first = _to_host(logits)[0]
        state = eng._recurrent_state(self.cache)
        self.cache = None              # the store holds every K/V row now
        eng.seqs[self.sid] = _SeqState(length=self.S,
                                       access=AccessTable(eng.n_chunks),
                                       state=state, prefill_logits=first,
                                       tokens=np.asarray(self.tokens),
                                       prompt_len=self.S)
        if self.pool_place:            # the decode thread's admission
            eng.last_logits = first
        if eng.ecfg.prefix_cache:
            # publish the registered chunks only once their write-behind
            # writes have landed: adopters read the arena row's replica
            eng.store.ingest_fence(self.sid)
            eng.store.finish_admission(self.sid)
        eng.admit_profiles.append({
            "total_s": time.perf_counter() - self._t0,
            "prefill_s": self._prefill_s, "ingest_s": self._ingest_s,
            "overlapped": float(eng._ingest_exec is not None),
            "chunked": 1.0, "chunks": float(self.n_steps),
            "prefix_hit_tokens": float(self._hit_tokens)})
        self.result = (self.sid, int(np.argmax(first)))

    @decode_thread_only
    def drain(self) -> Tuple[int, int]:
        """Run every remaining chunk back to back (no interleaving)."""
        while not self.done:
            self.step()
        return self.result


class LeoAMEngine:
    """Single-sequence view: a B=1 wrapper over the batched engine,
    preserving the prefill / decode_step / generate API."""

    def __init__(self, cfg, params, ecfg: EngineCfg, *,
                 device: DeviceLike = None, impl: Optional[str] = None,
                 store_root: Optional[str] = None):
        self._engine = BatchedLeoAMEngine(cfg, params, ecfg, max_seqs=1,
                                          device=device, impl=impl,
                                          store_root=store_root)
        self._sid: Optional[int] = None

    # passthroughs to the batched engine
    @property
    def cfg(self):
        return self._engine.cfg

    @property
    def ecfg(self):
        return self._engine.ecfg

    @property
    def chunk(self):
        return self._engine.chunk

    @property
    def n_chunks(self):
        return self._engine.n_chunks

    @property
    def attn_layers(self):
        return self._engine.attn_layers

    @property
    def store(self):
        return self._engine.store

    @property
    def round_profiles(self):
        return self._engine.round_profiles

    @property
    def admit_profiles(self):
        return self._engine.admit_profiles

    @property
    def length(self) -> int:
        return self._engine.seqs[self._sid].length if self._sid is not None \
            else 0

    @property
    def access(self):
        return self._engine.seqs[self._sid].access

    @property
    def stats(self) -> List[StepStats]:
        if self._sid is None:
            return []
        return self._engine.seqs[self._sid].stats

    def prefill(self, tokens: np.ndarray) -> int:
        if self._sid is not None:        # re-prefill resets
            self._engine.release(self._sid)
        self._sid, tok = self._engine.add_sequence(tokens)
        return tok

    def decode_step(self, token: int) -> int:
        if self._sid is None:
            raise ValueError(
                "decode_step before prefill: call prefill(prompt) (or "
                "generate) to admit the sequence before decoding")
        return self._engine.decode_round({self._sid: token})[self._sid]

    def generate(self, prompt: np.ndarray, n_tokens: int) -> List[int]:
        tok = self.prefill(prompt)
        out = [tok]
        for _ in range(n_tokens - 1):
            tok = self.decode_step(tok)
            out.append(tok)
        return out
