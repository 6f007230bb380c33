"""LeoAM serving engine: batched tiered decoding on a live model (PyTorch).

The port of ``repro.serving.engine`` for dense attention-only decoders
(the paper's own model, longchat-7b-32k).  Prefill populates the
three-tier store; each decode round runs, per attention layer, the paper's
Dynamic Three-tier Pipeline (§4.4):

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
fence):

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

Every kernel runs on the engine's device when it is the CUDA card; on the
CPU (``device="cpu"``) the plain PyTorch versions run.  ``impl="ref"``
asks for the plain versions on the card too.  Options of the reference
that the port leaves out so far raise ``NotImplementedError`` naming
their ROADMAP item: MLA, non-attention layers, the prefix cache and the
sync sanitizer.
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
from repro_torch.kernels.pq.ops import adc_chunk_scores
from repro_torch.kernels.sparse_decode.ops import (sparse_decode_pooled,
                                                   sparse_decode_workingset)
from repro_torch.models import attention as attn_mod
from repro_torch.models import lm
from repro_torch.models.common import rms_norm
from repro_torch.serving.faults import AdmissionError, ChunkLostError
from repro_torch.serving.offload import DEVICE, DISK, HOST, TieredKVStore
from repro_torch.serving.sanitizer import decode_thread_only, worker_thread


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
    bucket_prefill: bool = True      # pad prompts to power-of-two lengths
                                     # with the true length threaded
                                     # through — token-identical to exact
                                     # length (False: exact length)
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
    prefix_cache: bool = False       # not ported (ROADMAP A8)
    debug_sync: bool = False         # not ported (ROADMAP A13)
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
    fetched_bytes: float = 0.0
    abstract_bytes: float = 0.0


@dataclass
class _SeqState:
    """Host-side per-sequence decode state.  An attention-only stack keeps
    no model cache here: the tier store holds every K/V row."""
    length: int
    access: AccessTable
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
    """Batched tiered-decoding engine over a dense decoder-only model.

    Sequences join via :meth:`add_sequence`, decode together via
    :meth:`decode_round`, and leave via :meth:`release` — the surface
    :class:`~repro_torch.serving.scheduler.ContinuousBatcher` drives.
    ``params`` must already live on ``device``."""

    def __init__(self, cfg, params, ecfg: EngineCfg, *, max_seqs: int = 1,
                 device_chunk_budget: Optional[int] = None,
                 device: DeviceLike = None, impl: Optional[str] = None,
                 store_root: Optional[str] = None):
        lm.check_supported(cfg)
        for bad, opt, item in (
                (ecfg.prefix_cache, "prefix_cache=True", "A8"),
                (ecfg.debug_sync, "debug_sync=True", "A13")):
            if bad:
                raise NotImplementedError(
                    f"EngineCfg({opt}) is not ported yet (ROADMAP {item})")
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
        # the legacy device tier's budget is per store, the pool's per layer
        budget = (device_chunk_budget * len(self.attn_layers)
                  if device_chunk_budget is not None else None)
        self.store = TieredKVStore(
            len(self.attn_layers), self.n_chunks, self.chunk,
            cfg.n_kv_heads, cfg.hd, n_seqs=max_seqs,
            transit_codec=ecfg.transit_codec, root=store_root,
            device_budget=budget, use_pool=ecfg.pooled,
            pool_slots=device_chunk_budget, real_codec=ecfg.real_codec,
            disk_sidecar=ecfg.disk_sidecar,
            sidecar_lossless=ecfg.sidecar_lossless, checksums=ecfg.checksums,
            faults=ecfg.fault_plan, io_retries=ecfg.io_retries,
            io_backoff_s=ecfg.io_backoff_s,
            abstract_kind=("pq" if ecfg.pq_abstracts else "minmax"),
            pq_m=ecfg.pq_m, pq_centroids=ecfg.pq_centroids,
            pq_train_iters=ecfg.pq_train_iters, device=self.device, impl=impl)
        self.seqs: Dict[int, _SeqState] = {}
        # preempted sequences (suspend_sequence): their slot stays reserved
        self.suspended: Dict[int, _SeqState] = {}
        self._free: List[int] = list(range(max_seqs - 1, -1, -1))
        # DTP state: prefetch executor, per-(seq, layer) previous-round
        # selections, per-layer abstract cache, per-layer measured costs;
        # write-behind ingest rides the same worker
        self._executor = _prefetch_executor() if ecfg.pipeline else None
        self._ingest_exec = _prefetch_executor()
        self._pf_futs: Dict[int, Future] = {}
        self._abs_cache: Dict[int, Tuple] = {}
        self._prev_sels: Dict[Tuple[int, int], List[int]] = {}
        self._lcost: Dict[int, Dict[str, float]] = {}
        self.round_profiles: List[Dict[str, float]] = []
        self.admit_profiles: List[Dict[str, float]] = []
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
            with stream:
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
        placements deferred)."""
        S = len(tokens)
        t0 = time.perf_counter()
        logits, cache = self._prefill(np.asarray(tokens))
        placement = self._default_placement()
        ingest_s = 0.0
        # layer-streamed: hand each layer off as it reaches the host; the
        # replica/abstract writes go write-behind on the executor
        for li, layer in enumerate(self.attn_layers):
            k, v = self._layer_kv(cache, layer)
            t1 = time.perf_counter()
            self.store.ingest(li, k[0], v[0],
                              self._layer_placement(layer, placement),
                              seq=sid, executor=self._ingest_exec,
                              pool_place=pool_place)
            ingest_s += time.perf_counter() - t1
        prefill_s = time.perf_counter() - t0 - ingest_s
        first = _to_host(logits)[0]
        self.seqs[sid] = _SeqState(length=S,
                                   access=AccessTable(self.n_chunks),
                                   prefill_logits=first,
                                   tokens=np.asarray(tokens), prompt_len=S)
        self.admit_profiles.append({
            "total_s": time.perf_counter() - t0, "prefill_s": prefill_s,
            "ingest_s": ingest_s, "overlapped": 1.0})
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
        """Smallest bucket >= S: powers of two from 16, capped at max_len."""
        b = 16
        while b < S:
            b <<= 1
        return min(b, self.ecfg.max_len)

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
        with torch.no_grad():
            return lm.prefill(self.params, self.cfg, batch,
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

    def _layer_cache(self, cache, layer: int) -> Dict[str, torch.Tensor]:
        pro_n = len(cache["prologue"])
        if layer < pro_n:
            return cache["prologue"][layer]
        period = self.cfg.period()
        bi = (layer - pro_n) // period
        pi = (layer - pro_n) % period
        return {k: v[bi] for k, v in cache["body"][pi].items()}

    def _layer_kv(self, cache, layer: int) -> Tuple[np.ndarray, np.ndarray]:
        """(k, v) (B, S, Hkv, hd) of one layer, on the host."""
        c = self._layer_cache(cache, layer)
        return _to_host(c["k"]), _to_host(c["v"])

    def _layer_kv_slice(self, cache, layer: int, start: int, n: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Rows [start, start + n) of one layer's (k, v), batch row 0, on
        the host: a chunked admission's stream-out."""
        c = self._layer_cache(cache, layer)
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

    def _update_costs(self, li: int, upload_bytes: float, disk_bytes: float,
                      compute_s: float) -> None:
        """EMA of the layer's measured round costs (the compute window is
        (round − host stages)/n_attn without ``profile``)."""
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
            tiers = self.store.tier[sid, li]
            if not any_disk and any(tiers[c] == DISK for c in pred[sid]):
                any_disk = True
        if not any_disk:
            return
        key = tuple((sid, len(chunks_by_seq[sid])) for sid in order)

        @worker_thread
        def work():
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
        card), with ADC scores off the PQ codes for code-valid chunks when
        ``pq_abstracts`` is on, then per-sequence chunk-level adaptive
        selection on the host.  q: (B, H, hd) PRE-SCALED queries, rows
        matching ``order``."""
        cfg = self.cfg
        chunk = self.chunk
        n_valid = {sid: (int(L) + chunk - 1) // chunk
                   for sid, L in zip(order, lengths)}
        chunks_by_seq = {sid: list(range(n_valid[sid])) for sid in order}
        use_pq = self.ecfg.pq_abstracts
        fut = self._pf_futs.pop(li, None)
        if fut is not None:
            fut.result()
        cached = self._abs_cache.pop(li, None)
        key = tuple((sid, n_valid[sid]) for sid in order)
        if cached is not None and cached[0] == key:
            res = cached[1]
        else:   # speculation miss: sync read (the worker's read stays billed)
            res = self._read_abstracts(li, chunks_by_seq)
        if use_pq:
            km, kn, pq_codes, pq_valid, pq_cb, abs_billed = res
        else:
            km, kn, abs_billed = res
        ub, _ = chunk_bounds_gqa_matmul(q, torch.from_numpy(km).to(q.device),
                                        torch.from_numpy(kn).to(q.device),
                                        impl=self.impl)
        ub = ub.cpu().numpy()                                # (B, Hkv, ncmax)
        adc = None
        if use_pq and pq_valid.any():
            # asymmetric-distance scores off the PQ codes: q summed per kv
            # group against decoded centroids, max over a chunk's live
            # tokens.  Only code-valid chunks use them; the rest keep the
            # min/max upper bound BITWISE (np.where selects whole values)
            adc = adc_chunk_scores(group_sum(q, km.shape[2]), pq_cb,
                                   pq_codes, lengths).cpu().numpy()

        rate = (cfg.leoam.early_rate if layer < cfg.leoam.early_layers
                else cfg.leoam.importance_rate)
        sels: Dict[int, List[int]] = {}
        stats: Dict[int, StepStats] = {}
        for i, sid in enumerate(order):
            st = StepStats(abstract_bytes=abs_billed[sid])
            nv = n_valid[sid]
            length = int(lengths[i])
            scores = ub[i].max(0)[:nv]                       # (nv,)
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
            forced.update(range(max(0, nv - cfg.leoam.recent_chunks), nv))
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
            cs = cs | {c for (p, _li, c) in lost_all if p == sid}
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
        with torch.no_grad():
            while pos < end:
                chunk_toks = np.zeros(C, np.int64)
                take = min(C, len(toks) - pos)
                if take > 0:
                    chunk_toks[:take] = toks[pos:pos + take]
                batch = {"tokens": torch.from_numpy(
                    chunk_toks[None]).to(self.device),
                         "start": pos, "length": len(toks)}
                _, cache = lm.prefill_chunk(self.params, self.cfg, batch,
                                            cache, max_len=self.ecfg.max_len)
                pos += C
        lost_now = self.store.disk_lost_keys()
        for li, layer in enumerate(self.attn_layers):
            for c in sorted(set(cs)):
                if (sid, li, c) not in lost_now:
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
        x = torch.tensor([[tokens[sid]] for sid in order], dtype=torch.long,
                         device=dev)
        params = self.params
        h = params["embed"][x]                                   # (B, 1, d)
        H, hd = cfg.n_heads, cfg.hd

        prologue, period, repeats = lm._layer_plan(cfg)
        round_stats = {sid: StepStats() for sid in order}
        prof = {"eval_s": 0.0, "gather_s": 0.0, "upload_s": 0.0}
        layer_io: List[Tuple[int, float, float]] = []  # (li, upB, diskB)
        t_round = time.perf_counter()
        li = 0

        def run_attn(blk, mlpk, h, layer_idx):
            nonlocal li
            hln = rms_norm(h, blk["ln1"], cfg.norm_eps)
            q, k_new, v_new = attn_mod._qkv(blk["core"], cfg, hln, pos)
            qn = q[:, 0] / math.sqrt(hd)                         # (B, H, hd)
            t0 = time.perf_counter()
            sels, sel_stats = self._select_chunks_batched(
                li, layer_idx, qn, order, lengths)
            prof["eval_s"] += time.perf_counter() - t0

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
                    li, sels, pad_to=nmax, theta=self._theta(li))
                prof["gather_s"] += fst.gather_s
                prof["upload_s"] += fst.upload_s
                layer_io.append((li, fst.uploads * self.store.chunk_bytes,
                                 fst.disk_bytes))
                for sid in order:
                    round_stats[sid].fetched_bytes += fst.upload_bytes / B
                # overlap: next layer's reads under this layer's attention
                self._submit_prefetch(li + 1, order, lengths)
                o = sparse_decode_pooled(
                    q[:, 0], self.store.pools[li].kv,
                    torch.from_numpy(slots).to(dev),
                    torch.from_numpy(chunk_ids).to(dev), lengths_dev, k_new,
                    v_new, cfg.attn_softcap, impl=self.impl)
            else:
                # the legacy path: the host-assembled working set crosses
                # whole every round and B2 reads it in place
                t1 = time.perf_counter()
                kg, vg, _ = self.store.fetch_chunks_batch(li, sels,
                                                          pad_to=nmax)
                prof["gather_s"] += time.perf_counter() - t1
                t1 = time.perf_counter()
                kgd = torch.from_numpy(kg).to(dev)
                vgd = torch.from_numpy(vg).to(dev)
                prof["upload_s"] += time.perf_counter() - t1
                o = sparse_decode_workingset(
                    q[:, 0], kgd, vgd, torch.from_numpy(chunk_ids).to(dev),
                    lengths_dev, k_new, v_new, cfg.attn_softcap,
                    impl=self.impl)
            y = o.reshape(B, 1, H * hd) @ blk["core"]["wo"]
            self.store.append_tokens_batch(li, lengths, _to_host(k_new[:, 0]),
                                           _to_host(v_new[:, 0]), seqs=order)
            li += 1
            return lm._apply_mlp(blk, cfg, mlpk, h + y)

        for pi, (idx, _kind, mlpk) in enumerate(prologue):
            h = run_attn(params["prologue"][pi], mlpk, h, idx)
        for r in range(repeats):
            for pi, (_kind, mlpk) in enumerate(period):
                h = run_attn(lm.body_block(params, pi, r), mlpk, h, 10 ** 6)

        logits = _to_host(lm._logits(params, cfg, h)[:, 0])      # (B, V)
        self.last_logits = logits
        total_s = time.perf_counter() - t_round
        prof["total_s"] = total_s
        # the rest of the round: attention, MLPs, appends (the window the
        # θ balance must hide transfers under — an upper bound, as in the
        # reference without its profile mode)
        prof["attend_s"] = max(0.0, total_s - prof["eval_s"]
                               - prof["gather_s"] - prof["upload_s"])
        self.round_profiles.append(prof)
        # feed measured per-layer costs back into the θ balance
        tc = prof["attend_s"] / max(1, len(self.attn_layers))
        for lid, up_b, disk_b in layer_io:
            self._update_costs(lid, up_b, disk_b, tc)
        out: Dict[int, int] = {}
        for i, sid in enumerate(order):
            s = self.seqs[sid]
            s.length += 1
            s.stats.append(round_stats[sid])
            out[sid] = int(np.argmax(logits[i]))
        if ecfg.sidecar_requant and (ecfg.disk_sidecar or ecfg.pq_abstracts):
            # background repack of append-dirtied sidecars and re-encode of
            # their PQ codes (chunks quiet for a full round): long-running
            # sequences regain packed disk->host promotions and ADC scoring
            # instead of fp16 and the min/max box forever
            self.store.requant_sweep(executor=_prefetch_executor())
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
    ``result`` is (seq id, first token) once ``done``."""

    def __init__(self, engine: BatchedLeoAMEngine, sid: int,
                 tokens: np.ndarray, chunk_tokens: int):
        self.engine = engine
        self.sid = sid
        self.tokens = np.asarray(tokens)
        self.S = len(self.tokens)
        self.C = int(chunk_tokens)
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
        eng.store.ingest(li, k, v,
                         eng._layer_placement(layer, self.placement),
                         seq=self.sid, executor=eng._ingest_exec,
                         start=start)

    @decode_thread_only
    def step(self) -> int:
        """Advance one chunk; returns the prompt tokens it consumed (0 once
        done or cancelled)."""
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
        with torch.no_grad():
            logits, self.cache = lm.prefill_chunk(
                eng.params, eng.cfg, batch, self.cache,
                max_len=eng.ecfg.max_len)
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
        self.cache = None              # the store holds every row now
        eng.seqs[self.sid] = _SeqState(length=self.S,
                                       access=AccessTable(eng.n_chunks),
                                       prefill_logits=first,
                                       tokens=np.asarray(self.tokens),
                                       prompt_len=self.S)
        eng.last_logits = first
        eng.admit_profiles.append({
            "total_s": time.perf_counter() - self._t0,
            "prefill_s": self._prefill_s, "ingest_s": self._ingest_s,
            "overlapped": 1.0, "chunked": 1.0, "chunks": float(self.n_steps)})
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

    @property
    def attn_layers(self):
        return self._engine.attn_layers

    @property
    def store(self):
        return self._engine.store

    @property
    def length(self) -> int:
        return self._engine.seqs[self._sid].length if self._sid is not None \
            else 0

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
