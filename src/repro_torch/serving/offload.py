"""Three-tier KV store: device / host / disk with byte-accurate accounting.

The port of ``repro.serving.offload`` for the main path.  The unit of
placement is the (seq, layer, chunk) triple; one store serves a whole
decode batch.  The disk tier holds FULL fp16 REPLICAS of every chunk (one
shared memmap, CRC32 per chunk) plus its min/max abstract (paper §4.3):
demotions are metadata-only, promotions read the abstract or the chunk.

* a :class:`DeviceChunkPool` per layer is ONE CUDA tensor of chunk slots,
  updated in place; ``fetch_chunks_pooled`` uploads
  only the chunks not already resident (delta uploads) and returns slot
  indices that the engine's attention kernel reads by;
* with ``real_codec=True`` the θ-fraction of each upload crosses the link
  as packed int4/int8 (``core.compression.quantize_chunks`` on the host)
  and kernel B3 (``repro_torch.kernels.kv_quant``) dequantizes it straight
  into its pool slots — K and V planes of a layer's upload in one launch;
* write-behind prefill ingest: ``ingest(..., executor=...)`` applies the
  hot-tier placement synchronously and runs the disk replica + abstract
  writes on the executor; :meth:`TieredKVStore.ingest_fence` is the
  per-sequence completion fence.  ``start=`` ingests a chunk-aligned part
  of a sequence (chunked admission), and ``pool_place=False`` (admission
  on a worker thread) defers device placements into the pool's
  ``pending_place``, which the next ``fetch_chunks_pooled`` folds in on the
  decode thread, unbilled;
* per-sequence ``TrafficLog`` mirrors: the shared log always equals
  Σ seq_logs + Σ retired_logs;
* ``abstract_kind="pq"``: the PQ abstract plane — a per-layer codebook
  trained online from every ingested key chunk (k-means on kernels B4 and
  B5, ``repro_torch.kernels.pq``), uint8 codes per chunk on disk with a
  CRC each, and a requant sweep that re-encodes append-dirtied chunks once
  they go quiet.  The min/max boxes stay as the fallback for chunks whose
  codes are stale or corrupt;
* **packed disk sidecar** (``disk_sidecar=True``): beside the fp16 replica
  the store keeps ``kv_q.bin`` (int payload, two nibbles a byte for int4)
  and ``kv_scale.bin`` (one f32 scale per channel per chunk plane), the
  layout of ``compression.quantize_chunks`` with group == chunk, so one
  chunk's K+V sidecar is EXACTLY ``chunk_bytes * codec_ratio(codec,
  chunk)``.  Replica writes and disk→host promotions move (and bill) the
  packed bytes, dequantized on the host; a decode append invalidates the
  chunk's sidecar and the fp16 replica serves it (``kv_fallback`` when a
  CRC quarantines it) until the requant sweep repacks the quiet chunk.
  ``sidecar_lossless=True`` always reads the replica;
* the **legacy device tier** (``use_pool=False``, the reference's
  default): a dict of host numpy chunks capped by ``device_budget`` and
  evicted LRU, a tier label in the ledger, served by ``fetch_chunks`` /
  ``fetch_chunks_batch``, which assemble a round's working set on the host
  for the engine to upload whole;
* ``reopen=True`` re-attaches to a root after a crash: the memmaps open
  read-write, every chunk starts on DISK, and a chunk whose replica CRC
  never landed is rejected as disk-lost; ``checksums=False`` keeps no CRCs;
* the **fault domain**: every physical disk, sidecar, PQ-code and worker
  attempt passes one choke point (``_fault_point``) that consults an
  optional :class:`~repro_torch.serving.faults.FaultPlan`; transient disk
  errors retry with bounded back-off (``io_retries``, ``io_backoff_s``),
  and an exhausted budget degrades (sidecar → fp16 replica, PQ codes →
  min/max, replica → disk-lost for the engine to recompute).
  :meth:`TieredKVStore.restore_chunk` re-lands a recomputed chunk;
* **whole-sequence preemption**: :meth:`TieredKVStore.swap_out_seq` frees a
  suspended sequence's pool slots and host copies (the write-through
  replica already holds every row) and :meth:`TieredKVStore.swap_in_seq`
  re-stages the same set on the host off the replica.

Host-side state and billing are the reference's numpy code, so disk bytes,
abstracts and the traffic log are bitwise equal to ``repro``'s for the same
script (tested).  Options of the reference that the port leaves out raise
``NotImplementedError`` at construction, naming their ROADMAP item.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import zlib
from collections import OrderedDict, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.kv_quant.ops import kv_dequant_scatter
from repro_torch.kernels.pq.ops import pq_encode, pq_train
from repro_torch.serving.faults import (ChunkLostError, DiskIOExhausted,
                                        IngestError, TransientDiskError,
                                        WorkerFault)
from repro_torch.serving.sanitizer import (any_thread, decode_thread_only,
                                           worker_thread)

DEVICE, HOST, DISK = "device", "host", "disk"

# per-chunk checksum states (kv_crc_state.bin): NONE = never written; VALID
# = the stored CRC covers the replica bytes; DIRTY = a decode append
# changed the replica in place (served unverified, as in the reference)
_CRC_NONE, _CRC_VALID, _CRC_DIRTY = 0, 1, 2


@dataclass
class TrafficLog:
    bytes: Dict[Tuple[str, str, str], float] = field(
        default_factory=lambda: defaultdict(float))
    ops: Dict[Tuple[str, str, str], int] = field(
        default_factory=lambda: defaultdict(int))

    def record(self, src: str, dst: str, kind: str, nbytes: float) -> None:
        self.bytes[(src, dst, kind)] += nbytes
        self.ops[(src, dst, kind)] += 1

    def total(self, src: Optional[str] = None, kind: Optional[str] = None
              ) -> float:
        """Bytes recorded, summed over every entry from ``src`` of ``kind``
        (None matches any)."""
        return sum(v for (s, _d, k), v in self.bytes.items()
                   if (src is None or s == src)
                   and (kind is None or k == kind))


@dataclass
class FetchStats:
    """One pooled fetch's breakdown (per layer per round)."""
    hits: int = 0                # chunks already pool-resident
    uploads: int = 0             # chunks uploaded this call (the delta)
    compressed: int = 0          # uploads that crossed the link packed
    disk_reads: int = 0          # chunks staged disk→host first
    upload_bytes: float = 0.0    # host→device bytes billed
    disk_bytes: float = 0.0      # disk→host bytes billed
    gather_s: float = 0.0        # disk stage wall time
    upload_s: float = 0.0        # quantize + upload dispatch wall time


class DeviceChunkPool:
    """Fixed-capacity per-layer device slab of KV chunk slots.

    ``kv`` is ONE (n_slots + 1, planes, chunk, Hkv, hd) tensor on the
    device for the engine's lifetime, updated IN PLACE (no copy of the slab
    per round): codec uploads by kernel B3, the rest by index assignment.
    Slot ``n_slots`` is the reference's write-only scratch row; it is kept
    so slot numbering and the slab's shape match ``repro`` (this port needs
    no bucket padding: eager writes compile nothing).  ``slot_of`` maps (seq, chunk) → slot in
    LRU order."""

    def __init__(self, n_slots: int, chunk: int, kv_heads: int,
                 head_dim: int, dtype: torch.dtype, device: torch.device,
                 planes: int = 2):
        self.n_slots = n_slots
        self.planes = planes
        self.kv = torch.zeros((n_slots + 1, planes, chunk, kv_heads,
                               head_dim), dtype=dtype, device=device)
        self.slot_of: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        self.free: List[int] = list(range(n_slots - 1, -1, -1))
        # decode appends queue here and are folded into the next round's
        # slot upload — one slab update per (layer, round)
        self.pending: Dict[Tuple[int, int], Tuple[int, np.ndarray]] = {}
        # deferred prefill placements (admission on a worker thread): only
        # the decode thread writes the slab, so device-bound chunks queue
        # here, (planes, chunk, Hkv, hd) each, and the NEXT pooled fetch
        # folds them in — unbilled, like the synchronous prefill placement
        # (the KV was produced on the device).  Read and written under the
        # store lock by both threads
        self.pending_place: Dict[Tuple[int, int], np.ndarray] = {}
        self.hits = 0
        self.misses = 0
        self.uploads = 0

    def lookup(self, key: Tuple[int, int]) -> Optional[int]:
        slot = self.slot_of.get(key)
        if slot is not None:
            self.slot_of.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return slot

    def alloc(self, key: Tuple[int, int], pinned) -> Tuple[int,
                                                           Optional[Tuple]]:
        """Grab a slot for ``key``, evicting the LRU non-pinned resident if
        full.  Returns (slot, evicted key or None)."""
        if self.free:
            slot = self.free.pop()
            self.slot_of[key] = slot
            return slot, None
        for victim in self.slot_of:            # LRU → MRU
            if victim not in pinned:
                break
        else:
            raise RuntimeError(
                "device pool exhausted by a single round's working set; "
                "raise device_chunk_budget or lower the selection rate")
        slot = self.slot_of.pop(victim)
        self.pending.pop(victim, None)     # host copy keeps the rows
        self.slot_of[key] = slot
        return slot, victim

    def evict(self, key: Tuple[int, int]) -> None:
        slot = self.slot_of.pop(key, None)
        self.pending.pop(key, None)
        self.pending_place.pop(key, None)
        if slot is not None:
            self.free.append(slot)

    def evict_seq(self, seq: int) -> None:
        for key in [k for k in self.slot_of if k[0] == seq]:
            self.evict(key)
        for key in [k for k in self.pending_place if k[0] == seq]:
            self.pending_place.pop(key, None)

    @decode_thread_only
    def scatter(self, slots: Sequence[int], kv_plain, packed=None, *,
                codec: Optional[str] = None, impl: Optional[str] = None
                ) -> List[Tuple[int, int]]:
        """One slab update per (layer, round): write a delta into ``slots``
        AND flush the queued decode-append rows.  ``packed`` = (data,
        scale) is a codec payload on the device for the first ``len(slots)
        - len(kv_plain)`` slots: kernel B3 dequantizes it straight into
        them, one launch.  ``kv_plain`` (numpy (m, planes, chunk, Hkv, hd),
        or None) takes the remaining slots — the fp16 part of the delta,
        then any deferred placements — and the append rows follow, both by
        in-place index assignment.  Returns the (seq, chunk) keys
        whose append rows crossed to the device — the caller bills
        those."""
        dev = self.kv.device
        rows = [(key, slot, off, row)
                for key, (off, row) in self.pending.items()
                if (slot := self.slot_of.get(key)) is not None]
        n_comp = len(slots) - (0 if kv_plain is None else len(kv_plain))
        if packed is not None:
            kv_dequant_scatter(*packed, self.kv, slots[:n_comp], codec=codec,
                               impl=impl)
        if n_comp < len(slots):
            vals = torch.from_numpy(np.ascontiguousarray(kv_plain))
            idx = torch.as_tensor(list(slots[n_comp:]), dtype=torch.long,
                                  device=dev)
            self.kv[idx] = vals.to(device=dev, dtype=self.kv.dtype)
        if rows:
            si = torch.as_tensor([r[1] for r in rows], dtype=torch.long,
                                 device=dev)
            oi = torch.as_tensor([r[2] for r in rows], dtype=torch.long,
                                 device=dev)
            kv_rows = torch.from_numpy(np.stack([r[3] for r in rows]))
            self.kv[si, :, oi] = kv_rows.to(device=dev, dtype=self.kv.dtype)
        # clear AFTER the slab updates land: an exception mid-scatter must
        # not drop queued append rows
        self.pending.clear()
        self.uploads += len(slots)
        return [key for key, _, _, _ in rows]

    def queue_row(self, key: Tuple[int, int], off: int,
                  kv_row: np.ndarray) -> None:
        """Queue a decode-append row for a resident chunk; flushed by the
        next :meth:`scatter` (reads of the slab come only after it)."""
        self.pending[key] = (off, kv_row)


def _unsupported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"TieredKVStore({option}) is not ported yet (ROADMAP {item})")


class TieredKVStore:
    """Multi-sequence chunked K/V with device/host/disk placement.

    K/V chunks are (chunk, Hkv, hd) numpy arrays keyed by (seq, layer,
    chunk); ``_disk`` is a real memory-mapped file shared by all sequences.
    The device tier has two representations, as in the reference: the
    legacy dicts capped by ``device_budget`` (``use_pool=False``, served by
    ``fetch_chunks`` / ``fetch_chunks_batch``) and, with ``use_pool=True``,
    the per-layer :class:`DeviceChunkPool` slabs on ``device`` (default:
    the CUDA card), served by ``fetch_chunks_pooled``.  Mutating entry
    points take an RLock so the engine's prefetch thread can stage disk
    reads while the main thread decodes.  ``impl="ref"`` runs the plain
    versions of the dequant and k-means kernels even on the card."""

    def __init__(self, n_layers: int, n_chunks: int, chunk: int, kv_heads: int,
                 head_dim: int, *, n_seqs: int = 1, dtype=np.float16,
                 transit_codec="int4", root: Optional[str] = None,
                 device_budget: Optional[int] = None,
                 use_pool: bool = False, pool_slots: Optional[int] = None,
                 real_codec: bool = False, disk_sidecar: bool = False,
                 sidecar_lossless: bool = False, latent: bool = False,
                 prefix_rows: int = 0, debug_sync: bool = False,
                 checksums: bool = True, faults=None,
                 io_retries: int = 3, io_backoff_s: float = 1e-4,
                 reopen: bool = False,
                 abstract_kind: str = "minmax", pq_m: Optional[int] = None,
                 pq_centroids: int = 256, pq_train_iters: int = 4,
                 device: DeviceLike = None, impl: Optional[str] = None):
        for bad, opt, item in (
                (latent, "latent=True", "A7"),
                (prefix_rows, "prefix_rows>0", "A8"),
                (debug_sync, "debug_sync=True", "A13")):
            if bad:
                raise _unsupported(opt, item)
        if abstract_kind not in ("minmax", "pq"):
            raise ValueError(f"unknown abstract_kind {abstract_kind!r}")
        self.device = resolve_device(device)
        self.impl = impl
        self.n_seqs = n_seqs
        self.n_layers, self.n_chunks, self.chunk = n_layers, n_chunks, chunk
        self.kv_heads, self.head_dim = kv_heads, head_dim
        self.planes = 2
        self.dtype = np.dtype(dtype)
        self.torch_dtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
        self.transit_codec = transit_codec
        self.real_codec = real_codec and transit_codec is not None
        self.disk_sidecar = disk_sidecar and transit_codec is not None
        self.sidecar_lossless = sidecar_lossless
        self.device_budget = device_budget
        self.tier: np.ndarray = np.full((n_seqs, n_layers, n_chunks), HOST,
                                        object)
        self.access: np.ndarray = np.zeros((n_seqs, n_layers, n_chunks))
        self.log = TrafficLog()
        self.seq_logs: Dict[int, TrafficLog] = defaultdict(TrafficLog)
        self.retired_logs: List[TrafficLog] = []
        Key = Tuple[int, int, int]
        self._host_k: Dict[Key, np.ndarray] = {}
        self._host_v: Dict[Key, np.ndarray] = {}
        # the legacy device tier: host numpy chunks standing for the card,
        # in LRU order (OrderedDict front == least recent)
        self._dev_k: Dict[Key, np.ndarray] = {}
        self._dev_v: Dict[Key, np.ndarray] = {}
        self._lru: "OrderedDict[Key, None]" = OrderedDict()
        # persistent stacked abstracts: one (n_seqs, n_chunks, Hkv, hd)
        # fancy-index per (layer, round)
        self._abs_km = np.full((n_seqs, n_layers, n_chunks, kv_heads,
                                head_dim), -np.inf, np.float32)
        self._abs_kn = np.full_like(self._abs_km, np.inf)
        self._lock = threading.RLock()
        self.codec_uploads = 0         # pooled H2D chunks sent packed
        self.plain_uploads = 0         # pooled H2D chunks sent fp16
        self.pools: List[Optional[DeviceChunkPool]] = [None] * n_layers
        if use_pool:
            slots = pool_slots if pool_slots is not None \
                else n_seqs * n_chunks
            self.pools = [DeviceChunkPool(slots, chunk, kv_heads, head_dim,
                                          self.torch_dtype, self.device)
                          for _ in range(n_layers)]
        shape = (n_seqs, n_layers, n_chunks, self.planes, chunk, kv_heads,
                 head_dim)
        self._root = root or tempfile.mkdtemp(prefix="leoam_kv_")
        os.makedirs(self._root, exist_ok=True)
        # reopen=True re-attaches to the root after a crash: the memmaps
        # open read-write over whatever bytes survived, every chunk starts
        # on DISK, and a chunk whose cold ingest never landed (CRC state
        # NONE) is rejected as disk-lost instead of served torn
        self._reopened = bool(reopen)
        mode = "r+" if reopen else "w+"
        self._disk = np.memmap(os.path.join(self._root, "kv.bin"),
                               dtype=self.dtype, mode=mode, shape=shape)
        # packed sidecar: quantize_chunks(group=chunk) layout per (seq,
        # layer, chunk, K|V plane) — int payload + f32 per-channel scales.
        # _sidecar_valid gates reads: decode appends invalidate the chunk
        # (its scales go stale) and the fp16 replica serves as fallback
        self._disk_q = self._disk_scale = None
        self._sidecar_valid = np.zeros((n_seqs, n_layers, n_chunks), bool)
        if self.disk_sidecar:
            d = kv_heads * head_dim
            dq = compression.packed_dim(transit_codec, d)
            self._disk_q = np.memmap(
                os.path.join(self._root, "kv_q.bin"), dtype=np.int8,
                mode=mode, shape=(n_seqs, n_layers, n_chunks, self.planes,
                                  chunk, dq))
            self._disk_scale = np.memmap(
                os.path.join(self._root, "kv_scale.bin"), dtype=np.float32,
                mode=mode, shape=(n_seqs, n_layers, n_chunks, self.planes, d))
        # per-chunk CRC32s of the replica and of the packed sidecar,
        # persisted beside them and verified at every promotion.
        # ``faults`` is an optional serving.faults.FaultPlan consulted at
        # the single I/O choke points (tests and the chaos harness only)
        self.checksums = bool(checksums)
        self.faults = faults
        self.io_retries = int(io_retries)
        self.io_backoff_s = float(io_backoff_s)
        self._crc = self._crc_state = self._q_crc = None
        if self.checksums:
            self._crc = np.memmap(
                os.path.join(self._root, "kv_crc.bin"), dtype=np.uint32,
                mode=mode, shape=(n_seqs, n_layers, n_chunks))
            self._crc_state = np.memmap(
                os.path.join(self._root, "kv_crc_state.bin"),
                dtype=np.uint8, mode=mode, shape=(n_seqs, n_layers, n_chunks))
            if self.disk_sidecar:
                self._q_crc = np.memmap(
                    os.path.join(self._root, "kv_q_crc.bin"),
                    dtype=np.uint32, mode=mode,
                    shape=(n_seqs, n_layers, n_chunks))
        # PQ abstract plane (abstract_kind="pq"): per-layer product-
        # quantization codebooks learned online from ingested key chunks,
        # plus per-(seq, layer, chunk) uint8 codes on disk — the SECOND
        # abstract representation next to the min/max boxes, which stay as
        # the fallback for append-dirtied or corrupt codes.  ``_pq_valid``
        # gates ADC reads: any mutation of a chunk's replica clears it, and
        # the requant sweep re-encodes once the chunk goes quiet.
        self.pq = abstract_kind == "pq"
        self.pq_m = 0
        self.pq_centroids = int(pq_centroids)
        self.pq_train_iters = int(pq_train_iters)
        self._pq_codes = self._pq_codebook = self._pq_crc = None
        self._pq_cb = self._pq_counts = self._pq_valid = None
        self.pq_reencodes = 0
        if self.pq:
            self.pq_m = int(pq_m) if pq_m is not None \
                else max(1, head_dim // 8)
            if head_dim % self.pq_m:
                raise ValueError(
                    f"pq_m={self.pq_m} must divide head_dim={head_dim}")
            if not 0 < self.pq_centroids <= 256:
                raise ValueError("pq_centroids must fit uint8 codes")
            dsub = head_dim // self.pq_m
            self._pq_codes = np.memmap(
                os.path.join(self._root, "kv_pq.bin"), dtype=np.uint8,
                mode=mode, shape=(n_seqs, n_layers, n_chunks, chunk,
                                  kv_heads, self.pq_m))
            self._pq_codebook = np.memmap(
                os.path.join(self._root, "kv_pq_cb.bin"), dtype=np.float32,
                mode=mode, shape=(n_layers, self.pq_m, self.pq_centroids,
                                  dsub))
            # RAM mirrors: codebook reads (selection, encode) never touch
            # the memmap; counts make the online k-means a running mean.
            # A reopened store starts with every code invalid but keeps
            # the persisted codebook
            self._pq_cb = np.array(self._pq_codebook)
            self._pq_counts = np.zeros((n_layers, self.pq_m,
                                        self.pq_centroids), np.float64)
            self._pq_valid = np.zeros((n_seqs, n_layers, n_chunks), bool)
            if self.checksums:
                self._pq_crc = np.memmap(
                    os.path.join(self._root, "kv_pq_crc.bin"),
                    dtype=np.uint32, mode=mode,
                    shape=(n_seqs, n_layers, n_chunks))
        # codebook mutations (train/merge) serialize on a leaf lock so
        # cold-ingest workers never hold the store lock across them; the
        # k-means kernels themselves run OUTSIDE any lock
        # (snapshot-compute-merge)
        self._pq_lock = threading.Lock()
        self.fault_counters: Dict[str, int] = {
            "io_retries": 0, "checksum_failures": 0, "chunks_recomputed": 0,
            "pq_fallbacks": 0}
        self._stats_lock = threading.Lock()   # counters only; leaf lock
        self._disk_lost: Set[Tuple[int, int, int]] = set()
        # sequences served degraded numerics: a quarantined sidecar fell
        # back to the lossless fp16 replica
        self.degraded_seqs: Set[int] = set()
        # whole-sequence preemption: each suspended sequence's resident set
        # at swap-out, {seq: {layer: [chunks]}}, which swap_in_seq restores
        self._swapped: Dict[int, Dict[int, List[int]]] = {}
        self.seq_swapouts = 0
        self.seq_swapins = 0
        if reopen:
            # the hot tiers died with the process; all that survives is disk
            self.tier[:] = DISK
        # write-behind ingest: per-seq in-flight cold-write futures; the
        # fence pops under _futs_lock and waits OUTSIDE the store lock
        self._ingest_futs: Dict[int, List] = defaultdict(list)
        self._futs_lock = threading.Lock()
        # requant sweep: append-dirtied chunks keyed to the sweep round of
        # their LAST append; a chunk quiet for a full round is repacked
        # (sidecar) and re-encoded (PQ codes) in the background.  The
        # per-chunk version aborts a repack that raced a newer append (or
        # a slot reuse).
        self._requant_pending: Dict[Tuple[int, int, int], int] = {}
        self._chunk_version: Dict[Tuple[int, int, int], int] = \
            defaultdict(int)
        self._requant_futs: List = []
        self._sweep_round = 0
        self.sidecar_repacks = 0

    # ------------------------------------------------------------------
    @property
    def chunk_bytes(self) -> int:
        """One chunk's stored payload (K+V planes)."""
        return (self.planes * self.chunk * self.kv_heads * self.head_dim
                * self.dtype.itemsize)

    @property
    def abstract_bytes(self) -> int:
        """One chunk's LKA abstract: the (min, max) box pair over the keys."""
        return 2 * self.kv_heads * self.head_dim * self.dtype.itemsize

    @property
    def pq_bytes(self) -> int:
        """One chunk's PQ abstract: uint8 codes per (token, kv head, m)
        subvector — the bytes a ``pq_codes_read`` promotion moves."""
        return self.chunk * self.kv_heads * self.pq_m

    @property
    def row_bytes(self) -> int:
        """One appended token's stored bytes (K+V)."""
        return (self.planes * self.kv_heads * self.head_dim
                * self.dtype.itemsize)

    @property
    def use_pool(self) -> bool:
        return self.pools[0] is not None

    def _bill_flushed_rows(self, applied: List[Tuple[int, int]]) -> None:
        """Bill the HOST→DEVICE append rows a slab flush actually carried."""
        for seq, _c in applied:
            self._record(seq, HOST, DEVICE, "kv_append", self.row_bytes)

    def _record(self, seq: int, src: str, dst: str, kind: str,
                nbytes: float) -> None:
        """Tally into the shared log AND the sequence's mirror."""
        self.log.record(src, dst, kind, nbytes)
        self.seq_logs[seq].record(src, dst, kind, nbytes)

    def _transit_bytes(self) -> float:
        """Legacy ledger-only codec: chunk bytes scaled by the codec ratio."""
        nbytes = float(self.chunk_bytes)
        if self.transit_codec:
            nbytes *= compression.codec_ratio(self.transit_codec)
        return nbytes

    def _packed_bytes(self) -> float:
        """Actual packed payload bytes of one chunk through the real codec
        (per-chunk grouping, so the ratio is exact)."""
        return float(self.chunk_bytes) * compression.codec_ratio(
            self.transit_codec, group=self.chunk)

    def _disk_read_bytes(self) -> float:
        """Disk→host promotion bytes of one chunk read off the fp16
        replica: the full read in a real-codec or sidecar store, the
        ledger-only codec scaling otherwise (as the reference bills).
        Sidecar-valid chunks move :meth:`_packed_bytes` instead (decided
        per key in :meth:`_stage_disk`)."""
        return float(self.chunk_bytes) if (self.real_codec
                                           or self.disk_sidecar) \
            else self._transit_bytes()

    def _plane_stack(self, kc: np.ndarray, vc: np.ndarray) -> np.ndarray:
        """One chunk's storage planes: (2, chunk, Hkv, hd)."""
        return np.stack((kc, vc))

    def _sidecar_ok(self, seq: int, layer: int, c: int) -> bool:
        """True when the packed sidecar serves this chunk's disk reads."""
        return (self.disk_sidecar and not self.sidecar_lossless
                and bool(self._sidecar_valid[seq, layer, c]))

    @staticmethod
    def _crc32(arr: np.ndarray) -> int:
        return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF

    def _sidecar_crc(self, data: np.ndarray, scale: np.ndarray) -> int:
        """One chunk's packed-sidecar CRC: payload planes then scales, in
        the (planes, chunk, dq) / (planes, d) read layout."""
        z = zlib.crc32(np.ascontiguousarray(data).tobytes())
        return zlib.crc32(np.ascontiguousarray(scale).tobytes(), z) \
            & 0xFFFFFFFF

    def _count(self, name: str, n: int = 1) -> None:
        """Bump a fault counter (worker and decode threads both count)."""
        with self._stats_lock:
            self.fault_counters[name] = \
                self.fault_counters.get(name, 0) + n

    def _fault_point(self, site: str, key=None) -> None:
        """The injection choke point: every physical disk, sidecar, PQ-code
        and worker attempt consults the plan here exactly once.  ``key``
        for read sites is the list of (row, layer, chunk) the attempt
        covers — a scheduled bitflip corrupts the first one's stored
        bytes."""
        plan = self.faults
        if plan is None:
            return
        kind = plan.check(site, key)
        if kind is None:
            return
        if kind == "latency":
            time.sleep(plan.latency_s)
        elif kind == "io_error":
            raise TransientDiskError(f"injected transient {site} error")
        elif kind == "exception":
            raise WorkerFault(f"injected worker fault at {site}")
        elif kind == "bitflip" and site in ("disk_read", "sidecar_read",
                                            "pq_read"):
            self._flip_bit(site, key)

    def _flip_bit(self, site: str, key) -> None:  # leolint: waive[billlint] reason=fault-injection hook: corrupts stored bytes in place to model silent media corruption; no tier transfer occurs, nothing is promoted or billed
        """Flip one stored bit of the first targeted chunk — silent media
        corruption the checksum layer must catch at the next promotion.
        The same bit as the reference's: the first byte's 0x01 of the PQ
        codes, 0x40 of the sidecar payload, and bit 10 of the replica's
        first fp16 word."""
        if not key:
            return
        p, layer, c = key[0]
        if site == "pq_read" and self._pq_codes is not None:
            buf = self._pq_codes[p, layer, c].reshape(-1)
            buf[0] = np.uint8(int(buf[0]) ^ 0x01)
        elif site == "sidecar_read" and self._disk_q is not None:
            buf = self._disk_q[p, layer, c].reshape(-1)
            buf[0] = np.int8(int(buf[0]) ^ 0x40)
        else:
            flat = self._disk[p, layer, c].reshape(-1)
            word = np.uint16 if self.dtype.itemsize == 2 else np.uint32
            cell = flat[:1].view(word)
            cell[0] ^= np.asarray(1 << 10, word)
        if hasattr(self.faults, "record_key"):
            self.faults.record_key((int(p), int(layer), int(c)))

    def _with_retries(self, fn):
        """Run one physical I/O attempt with bounded retry-with-backoff on
        transient errors.  Each retry re-consults the fault plan at the
        NEXT call index, so one scheduled ``io_error`` is a transient blip
        (value-identical after the retry) and ``io_retries + 1``
        consecutive ones a persistent failure, raised as
        :class:`DiskIOExhausted` for the caller to degrade on."""
        last: Optional[BaseException] = None
        for attempt in range(self.io_retries + 1):
            try:
                return fn()
            except TransientDiskError as e:
                last = e
                self._count("io_retries")
                if attempt < self.io_retries:
                    time.sleep(self.io_backoff_s * (2 ** attempt))
        raise DiskIOExhausted(
            f"disk I/O failed after {self.io_retries + 1} attempts: "
            f"{last}") from last

    def _read_sidecar(self, layer: int,  # leolint: waive[billlint] reason=coalesced read helper: every caller (_stage_disk, fetch_chunks) bills _packed_bytes() (or the fp16 fallback) per key at its own promotion site
                      keys: Sequence[Tuple[int, int]]
                      ) -> Tuple[np.ndarray, Set[int]]:
        """Coalesced packed-sidecar read, dequantized on the host: every
        storage plane of every (seq, chunk) key.  Returns ``(out, bad)``:
        out is (n, planes, chunk, Hkv, hd) in store dtype; ``bad`` holds
        the positions whose payload failed its CRC — those rows are
        garbage, the sidecar is quarantined (valid bit cleared, counted)
        and the caller falls back to the fp16 replica.  The gather runs
        through the ``sidecar_read`` choke point with bounded retry."""
        sq = np.array([s for s, _ in keys])
        cq = np.array([c for _, c in keys])

        def read():  # leolint: waive[billlint] reason=retryable attempt body of the coalesced helper; billing happens at the callers' promotion sites
            self._fault_point("sidecar_read",
                              [(p, layer, c) for p, c in keys])
            return (np.asarray(self._disk_q[sq, layer, cq]),
                    np.asarray(self._disk_scale[sq, layer, cq]))

        # (n, planes, chunk, dq) payload and (n, planes, d) scales
        data, scale = self._with_retries(read)
        bad: Set[int] = set()
        if self._q_crc is not None:
            for i, (p, c) in enumerate(keys):
                if self._sidecar_crc(data[i], scale[i]) != \
                        int(self._q_crc[p, layer, c]):
                    bad.add(i)
                    self._sidecar_valid[p, layer, c] = False
                    self._count("checksum_failures")
        out = np.empty((len(keys), self.planes, self.chunk, self.kv_heads,
                        self.head_dim), self.dtype)
        for plane in range(self.planes):
            out[:, plane] = compression.dequantize_chunks(
                data[:, plane], scale[:, plane], self.transit_codec,
                self.kv_heads, self.head_dim, dtype=self.dtype)
        return out, bad

    def _replica_read_verified(self, layer: int,  # leolint: waive[billlint] reason=coalesced verified-read helper: its callers (_stage_disk, fetch_chunks) bill every chunk they promote at the promotion site, where the per-seq attribution and the fallback kind are known
                               entries: Sequence[Tuple[int, int, int]]
                               ) -> Tuple[np.ndarray, Set[int]]:
        """Coalesced fp16-replica gather through the ``disk_read`` choke
        point with bounded retry, plus CRC verification.  ``entries`` is
        (bill seq, row, chunk).  Returns (blk, lost): blk is (n, planes,
        chunk, Hkv, hd); ``lost`` positions failed verification (replica
        corrupt or, in a reopened store, never landed) and are marked
        disk-lost."""
        sq = np.array([p for _, p, _ in entries])
        cq = np.array([c for _, _, c in entries])

        def read():  # leolint: waive[billlint] reason=retryable attempt body of the coalesced helper; billing happens at the callers' promotion sites
            self._fault_point("disk_read",
                              [(p, layer, c) for _, p, c in entries])
            return np.asarray(self._disk[sq, layer, cq])

        blk = self._with_retries(read)
        lost: Set[int] = set()
        if self._crc is not None:
            for i, (_, p, c) in enumerate(entries):
                state = int(self._crc_state[p, layer, c])
                ok = True
                if state == _CRC_VALID:
                    ok = self._crc32(blk[i]) == int(self._crc[p, layer, c])
                elif state == _CRC_NONE and self._reopened:
                    ok = False       # torn ingest: the cold write never landed
                if not ok:
                    lost.add(i)
                    if (p, layer, c) not in self._disk_lost:
                        self._disk_lost.add((p, layer, c))
                        self._count("checksum_failures")
        return blk, lost

    # ------------------------------------------------------------------
    # Ingest (prefill) with write-behind cold half
    # ------------------------------------------------------------------
    @worker_thread
    def ingest(self, layer: int, k: np.ndarray, v: np.ndarray,
               placement: Optional[Dict[int, str]] = None, *, seq: int = 0,
               executor=None, pool_place: bool = True,
               start: int = 0) -> None:
        """Store prefill KV.  k/v: (S, Hkv, hd).  Every chunk is replicated
        to disk (with its abstract, and its packed sidecar in a sidecar
        store); ``placement`` assigns the hot tier.  With ``executor`` the
        cold half (disk replica, sidecar and abstract writes and their
        billing) runs write-behind; reads of the disk tier or the abstracts
        need :meth:`ingest_fence` first.

        ``pool_place=False`` (ingest on a thread other than the decode
        thread, whose attention reads the pool slab) defers each would-be
        DEVICE chunk of a pooled store into the pool's ``pending_place``
        and tiers it HOST; the next :meth:`fetch_chunks_pooled` places it.  ``start`` (a
        chunk-aligned token position) ingests a PART of the sequence: rows
        land in chunks ``start // chunk`` onward, ``placement`` stays keyed
        by global chunk id, and every call's cold writes join the same
        per-sequence fence."""
        if start % self.chunk:
            raise ValueError(
                f"ingest start={start} must be a multiple of the store "
                f"chunk ({self.chunk}): partial ingests land whole chunks")
        placement = placement or {}
        c0 = start // self.chunk
        with self._lock:
            S = k.shape[0]
            to_pool: List[Tuple[int, np.ndarray, np.ndarray]] = []
            cids: List[int] = []
            kcs: List[np.ndarray] = []
            vcs: List[np.ndarray] = []
            for j in range(min(self.n_chunks - c0,
                               (S + self.chunk - 1) // self.chunk)):
                c = c0 + j
                kr = k[j * self.chunk: (j + 1) * self.chunk]
                vr = v[j * self.chunk: (j + 1) * self.chunk]
                if kr.shape[0] < self.chunk:
                    pad = self.chunk - kr.shape[0]
                    kr = np.pad(kr, ((0, pad), (0, 0), (0, 0)))
                    vr = np.pad(vr, ((0, pad), (0, 0), (0, 0)))
                kc = kr.astype(self.dtype)
                vc = vr.astype(self.dtype)
                cids.append(c)
                kcs.append(kc)
                vcs.append(vc)
                where = placement.get(c, HOST)
                if where == DEVICE and self.use_pool and not pool_place:
                    # the decode thread reads the slab outside the lock:
                    # queue the placement for its next pooled fetch
                    self.pools[layer].pending_place[(seq, c)] = \
                        self._plane_stack(kc, vc)
                    where = HOST
                self.tier[seq, layer, c] = where
                key = (seq, layer, c)
                if where in (HOST, DEVICE):
                    self._host_k[key], self._host_v[key] = kc, vc
                if where == DEVICE:
                    if self.use_pool:
                        to_pool.append((c, kc, vc))
                    else:
                        self._promote_device(key, kc, vc)
            if to_pool:
                # leolint: waive[locklint,threadlint] reason=decode-thread ingest only: to_pool fills only when pool_place=True, which the admission worker never passes (it defers via pending_place), and the slab update is an eager in-place device write, not a compiled dispatch
                self._pool_place(layer, seq, to_pool)
        if not cids:
            return
        ks, vs = np.stack(kcs), np.stack(vcs)
        if executor is None:
            self._ingest_cold(layer, seq, cids, ks, vs)
        else:
            fut = executor.submit(self._ingest_cold, layer, seq, cids, ks, vs)
            with self._futs_lock:
                self._ingest_futs[seq].append(fut)

    @worker_thread
    def _ingest_cold(self, layer: int, seq: int, cids: List[int],
                     kcs: np.ndarray, vcs: np.ndarray) -> None:
        """The write-behind half of :meth:`ingest`: fp16 replica, packed
        sidecar, CRC and abstract writes (and, in a PQ store, the codebook
        update and the chunks' codes), with their billing.  kcs/vcs: (n,
        chunk, Hkv, hd) in store dtype, rows matching ``cids``."""
        # an injected worker fault (an arbitrary bug in this work item)
        # propagates through the future and surfaces at the sequence's
        # ingest fence as IngestError: that sequence's terminal state alone
        self._fault_point("worker", (layer, seq))
        n = len(cids)
        packed = None
        if self.disk_sidecar:
            # quantize OUTSIDE the lock (pure compute on private arrays):
            # holding it here would stall the decode thread's fetches
            packed = tuple(compression.quantize_chunks(p, self.transit_codec)
                           for p in (kcs, vcs))
        # checksums over the exact bytes about to land, computed outside
        # the lock; CRC rows are metadata (4 B a chunk), not billed
        crcs = q_crcs = None
        if self._crc is not None:
            crcs = [self._crc32(self._plane_stack(kcs[i], vcs[i]))
                    for i in range(n)]
        if packed is not None and self._q_crc is not None:
            q_crcs = [self._sidecar_crc(np.stack([pd[i] for pd, _ in packed]),
                                        np.stack([ps[i] for _, ps in packed]))
                      for i in range(n)]
        # PQ plane: fold this batch's key vectors into the layer's online
        # codebook and encode every chunk.  The k-means kernels and the
        # device->host copies that end them run OUTSIDE any lock; the
        # codebook mirror is snapshotted and merged back under the leaf
        # _pq_lock (last writer wins: codebook drift is estimator error,
        # never a correctness hazard — attention always reads real KV)
        pq_codes_arr = pq_crcs = None
        if self.pq:
            vecs = kcs.reshape(-1, self.head_dim).astype(np.float32)
            # tail-chunk zero padding (and all-zero rows past the prompt)
            # must not poison the codebook: train on non-zero rows only
            train = vecs[np.any(vecs != 0.0, axis=1)]
            with self._pq_lock:
                cb0 = self._pq_cb[layer].copy()
                cnt0 = self._pq_counts[layer].copy()
            cb1, cnt1 = pq_train(train, cb0, cnt0, iters=self.pq_train_iters,
                                 impl=self.impl, device=self.device)
            pq_codes_arr = pq_encode(vecs, cb1, impl=self.impl,
                                     device=self.device).reshape(
                n, self.chunk, self.kv_heads, self.pq_m)
            with self._pq_lock:
                self._pq_cb[layer] = cb1
                self._pq_counts[layer] = cnt1
                self._pq_codebook[layer] = cb1
            if self._pq_crc is not None:
                pq_crcs = [self._crc32(pq_codes_arr[i]) for i in range(n)]
        # transient write errors retry here, outside the lock; exhaustion
        # (DiskIOExhausted) surfaces at the fence, not in a decode round
        self._with_retries(
            lambda: self._fault_point("disk_write", (layer, seq)))
        with self._lock:
            idx = np.asarray(cids, np.int64)
            self._disk[seq, layer, idx, 0] = kcs
            self._disk[seq, layer, idx, 1] = vcs
            self._abs_km[seq, layer, idx] = kcs.max(1)
            self._abs_kn[seq, layer, idx] = kcs.min(1)
            if crcs is not None:
                self._crc[seq, layer, idx] = crcs
                self._crc_state[seq, layer, idx] = _CRC_VALID
            rep_bytes = float(self.chunk_bytes)
            if packed is not None:
                for pl, (pd, ps) in enumerate(packed):
                    self._disk_q[seq, layer, idx, pl] = pd
                    self._disk_scale[seq, layer, idx, pl] = ps
                self._sidecar_valid[seq, layer, idx] = True
                if q_crcs is not None:
                    self._q_crc[seq, layer, idx] = q_crcs
                rep_bytes = self._packed_bytes()
            if pq_codes_arr is not None:
                self._pq_codes[seq, layer, idx] = pq_codes_arr
                self._pq_valid[seq, layer, idx] = True
                if pq_crcs is not None:
                    self._pq_crc[seq, layer, idx] = pq_crcs
                # write-through codebook persistence, billed once per cold
                # batch (it is shared state, K * head_dim floats)
                self._record(seq, HOST, DISK, "pq_codes_write",
                             4.0 * self.pq_m * self.pq_centroids
                             * (self.head_dim // self.pq_m))
            for _c in cids:
                self._record(seq, HOST, DISK, "kv_replica", rep_bytes)
                self._record(seq, HOST, DISK, "abstract", self.abstract_bytes)
                if pq_codes_arr is not None:
                    self._record(seq, HOST, DISK, "pq_codes_write",
                                 float(self.pq_bytes))

    @any_thread
    def ingest_fence(self, seq: int) -> None:
        """Block until every in-flight write-behind ingest of ``seq`` has
        landed.  Must be called WITHOUT the store lock held.  All futures
        are awaited even when one raises; the first failure re-raises as
        :class:`IngestError`."""
        with self._futs_lock:
            futs = self._ingest_futs.pop(seq, [])
        first: Optional[BaseException] = None
        for fut in futs:
            try:
                fut.result()
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None:
            raise IngestError(seq, first) from first

    @any_thread
    def ingest_fence_all(self) -> None:
        """Fence every sequence (shutdown path)."""
        with self._futs_lock:
            seqs = list(self._ingest_futs)
        first: Optional[BaseException] = None
        for s in seqs:
            try:
                self.ingest_fence(s)
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None:
            raise first

    @decode_thread_only
    def _pool_place(self, layer: int, seq: int,
                    items: List[Tuple[int, np.ndarray, np.ndarray]]) -> None:
        """Initial (prefill) pool placement: one scatter, no transit billing
        — the KV was produced on the device; this is residency bookkeeping."""
        pool = self.pools[layer]
        slots = []
        for c, _, _ in items:
            slot, evicted = pool.alloc((seq, c), pinned=())
            if evicted is not None:
                self.tier[evicted[0], layer, evicted[1]] = HOST
            slots.append(slot)
        self._bill_flushed_rows(
            pool.scatter(slots, np.stack([self._plane_stack(kc, vc)
                                          for _, kc, vc in items])))

    @any_thread
    def tier_view(self, seq: int, layer: int) -> np.ndarray:
        """A copy of the sequence's tier row for one layer (what the
        engine's prefetch planner reads)."""
        with self._lock:
            return np.array(self.tier[seq, layer], copy=True)

    # ------------------------------------------------------------------
    def read_abstracts(self, layer: int, chunks: Sequence[int], *,
                       seq: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """LKA: fetch (kmax, kmin) for one sequence's chunks; each disk
        chunk costs one abstract read."""
        with self._lock:
            idx = np.asarray(list(chunks), np.int64)
            for c in idx:
                if self.tier[seq, layer, c] == DISK:
                    self._record(seq, DISK, HOST, "abstract",
                                 self.abstract_bytes)
            return (self._abs_km[seq, layer, idx].copy(),
                    self._abs_kn[seq, layer, idx].copy())

    @any_thread
    def read_abstracts_batch(self, layer: int,
                             chunks_by_seq: Dict[int, Sequence[int]]
                             ) -> Tuple[np.ndarray, np.ndarray,
                                        Dict[int, float]]:
        """Batched LKA read: one padded (B, ncmax, Hkv, hd) fancy-index into
        the persistent abstract stack.  Returns (kmax, kmin, abstract bytes
        billed per sequence); rows follow dict order, padded with zeros."""
        with self._lock:
            B = len(chunks_by_seq)
            ncmax = max((len(c) for c in chunks_by_seq.values()), default=0)
            km = np.zeros((B, ncmax, self.kv_heads, self.head_dim), np.float32)
            kn = np.zeros_like(km)
            billed: Dict[int, float] = {}
            for i, (seq, chunks) in enumerate(chunks_by_seq.items()):
                idx = np.asarray(list(chunks), np.int64)
                km[i, :len(idx)] = self._abs_km[seq, layer, idx]
                kn[i, :len(idx)] = self._abs_kn[seq, layer, idx]
                n_disk = int(np.count_nonzero(
                    self.tier[seq, layer, idx] == DISK))
                for _ in range(n_disk):
                    self._record(seq, DISK, HOST, "abstract",
                                 self.abstract_bytes)
                billed[seq] = n_disk * float(self.abstract_bytes)
            return km, kn, billed

    @any_thread
    def read_abstracts_pq_batch(self, layer: int,
                                chunks_by_seq: Dict[int, Sequence[int]]
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray,
                                           np.ndarray, Dict[int, float]]:
        """Batched PQ abstract read: codes + validity next to the min/max
        boxes, so the engine scores valid chunks by ADC and falls back to
        the bounds product BITWISE for the rest (append-dirtied or corrupt
        codes).  Returns ``(kmax, kmin, codes, valid, codebook, billed)``;
        codes is (B, ncmax, chunk, Hkv, m) uint8, valid (B, ncmax) bool,
        codebook the layer's (m, K, dsub) snapshot.  Billing per disk-tier
        chunk: ``pq_codes_read`` when its codes serve, ``abstract`` when it
        degrades.  Each code block is CRC-verified; a mismatch quarantines
        the chunk's codes into the requant queue (the sweep re-encodes it
        off the replica).  The code gather runs through the ``pq_read``
        choke point with bounded retry; an exhausted budget degrades the
        whole gather to min/max (counted in ``pq_fallbacks``) — selection
        is an estimator, never worth failing a round over."""
        if not self.pq:
            raise ValueError("store built with abstract_kind='minmax'")
        with self._lock:
            B = len(chunks_by_seq)
            ncmax = max((len(c) for c in chunks_by_seq.values()), default=0)
            km = np.zeros((B, ncmax, self.kv_heads, self.head_dim),
                          np.float32)
            kn = np.zeros_like(km)
            codes = np.zeros((B, ncmax, self.chunk, self.kv_heads,
                              self.pq_m), np.uint8)
            valid = np.zeros((B, ncmax), bool)
            billed: Dict[int, float] = {}
            for i, (seq, chunks) in enumerate(chunks_by_seq.items()):
                idx = np.asarray(list(chunks), np.int64)
                km[i, :len(idx)] = self._abs_km[seq, layer, idx]
                kn[i, :len(idx)] = self._abs_kn[seq, layer, idx]
                pqv = np.array(self._pq_valid[seq, layer, idx])

                def read():
                    self._fault_point("pq_read", [(seq, layer, int(c))
                                                  for c in idx])
                    return np.asarray(self._pq_codes[seq, layer, idx])

                blk = None
                if pqv.any():
                    try:
                        blk = self._with_retries(read)
                    except DiskIOExhausted:
                        # persistent code-read failure: every chunk of
                        # this gather degrades to its min/max box
                        self._count("pq_fallbacks",
                                    int(np.count_nonzero(pqv)))
                        pqv[:] = False
                if blk is not None and self._pq_crc is not None:
                    for j in np.nonzero(pqv)[0]:
                        c = int(idx[j])
                        if self._crc32(blk[j]) != int(
                                self._pq_crc[seq, layer, c]):
                            # silent media corruption: min/max serves the
                            # chunk until the sweep re-encodes it
                            pqv[j] = False
                            self._pq_valid[seq, layer, c] = False
                            self._requant_pending.setdefault(
                                (seq, layer, c), self._sweep_round)
                            self._count("checksum_failures")
                            self._count("pq_fallbacks")
                if blk is not None:
                    codes[i, :len(idx)][pqv] = blk[pqv]
                valid[i, :len(idx)] = pqv
                disk = np.asarray(self.tier[seq, layer, idx] == DISK)
                n_pq = int(np.count_nonzero(disk & pqv))
                n_mm = int(np.count_nonzero(disk & ~pqv))
                for _ in range(n_pq):
                    self._record(seq, DISK, HOST, "pq_codes_read",
                                 float(self.pq_bytes))
                for _ in range(n_mm):
                    self._record(seq, DISK, HOST, "abstract",
                                 self.abstract_bytes)
                billed[seq] = (n_pq * float(self.pq_bytes)
                               + n_mm * float(self.abstract_bytes))
            with self._pq_lock:
                cb = self._pq_cb[layer].copy()
            return km, kn, codes, valid, cb, billed

    # ------------------------------------------------------------------
    # Legacy device tier: host-assembled working sets
    # ------------------------------------------------------------------
    def _promote_device(self, key: Tuple[int, int, int], kc: np.ndarray,
                        vc: np.ndarray) -> None:
        """Pin a chunk in the legacy device tier, demoting LRU chunks past
        the shared budget to HOST (free: the host copies and disk replicas
        survive)."""
        self._dev_k[key], self._dev_v[key] = kc, vc
        self.tier[key[0], key[1], key[2]] = DEVICE
        self._lru[key] = None
        self._lru.move_to_end(key)
        if self.device_budget is not None:
            while len(self._dev_k) > self.device_budget:
                victim, _ = self._lru.popitem(last=False)
                self._dev_k.pop(victim, None)
                self._dev_v.pop(victim, None)
                self.tier[victim[0], victim[1], victim[2]] = HOST

    def _touch(self, key: Tuple[int, int, int]) -> None:
        self._lru.move_to_end(key)

    @decode_thread_only
    def fetch_chunks(self, layer: int, chunks: Sequence[int], *,
                     seq: int = 0, to_device: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Promote one sequence's chunks into the legacy device tier;
        returns stacked K/V (n, chunk, Hkv, hd).  A disk chunk is read off
        its packed sidecar when that is valid, else off the fp16 replica;
        a lost replica raises :class:`ChunkLostError`."""
        with self._lock:
            ks, vs = [], []
            for c in chunks:
                key = (seq, layer, c)
                self.access[seq, layer, c] += 1
                if key in self._dev_k:
                    self._touch(key)
                    ks.append(self._dev_k[key])
                    vs.append(self._dev_v[key])
                    continue
                if self.tier[seq, layer, c] == DISK or key not in self._host_k:
                    kc = vc = None
                    fell_back = False
                    if self._sidecar_ok(seq, layer, c):
                        try:
                            # leolint: waive[locklint] reason=decode-thread fetch path: the sidecar dequant runs under the short fetch critical section, as in the reference (tier tables must not move mid-fetch)
                            kv, bad = self._read_sidecar(layer, [(seq, c)])
                        except DiskIOExhausted:
                            kv, bad = None, {0}
                        if bad:
                            # quarantined (CRC mismatch) or unreadable:
                            # degrade to the lossless fp16 replica below
                            fell_back = True
                        else:
                            kc, vc = kv[0][0], kv[0][1]
                            nb = self._packed_bytes()
                    if kc is None:
                        try:
                            blk, lost = self._replica_read_verified(
                                layer, [(seq, seq, c)])
                        except DiskIOExhausted:
                            blk, lost = None, {0}
                            self._disk_lost.add((seq, layer, c))
                        if blk is None or lost:
                            # the replica is gone too: the typed loss for
                            # the engine to recompute or contain
                            raise ChunkLostError(layer, [(seq, seq, c)])
                        kc, vc = blk[0][0], blk[0][1]
                        nb = (self._disk_read_bytes() if self.disk_sidecar
                              else self._transit_bytes())
                    if fell_back:
                        self.degraded_seqs.add(seq)
                        self._record(seq, DISK, HOST, "kv_fallback", nb)
                    else:
                        self._record(seq, DISK, HOST, "kv", nb)
                    self._host_k[key], self._host_v[key] = kc, vc
                kc, vc = self._host_k[key], self._host_v[key]
                self._record(seq, HOST, DEVICE, "kv", self._transit_bytes())
                if to_device:
                    self._promote_device(key, kc, vc)
                ks.append(kc)
                vs.append(vc)
            return np.stack(ks), np.stack(vs)

    @decode_thread_only
    def fetch_chunks_batch(self, layer: int,
                           chunks_by_seq: Dict[int, Sequence[int]], *,
                           pad_to: Optional[int] = None, to_device: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch-coalesced promotion for one decode round of one layer on
        the legacy path: every disk-resident (seq, chunk) pair of the batch
        is read in ONE gather, then each sequence's ragged selection is
        padded to ``pad_to`` (default: the round's max).

        Returns (kg, vg, nsel): kg/vg (B, pad_to, chunk, Hkv, hd) in store
        dtype with zero padding — the working set the engine uploads whole
        — and nsel (B,) the valid chunk counts.  Rows follow dict order.
        Every chunk not in the legacy device tier bills a host→device
        upload, as in the reference."""
        with self._lock:
            items = list(chunks_by_seq.items())
            B = len(items)
            nsel = np.array([len(c) for _, c in items], np.int32)
            nmax = int(pad_to if pad_to is not None
                       else (nsel.max() if B else 0))
            # leolint: waive[locklint] reason=decode-thread batch fetch: disk staging (and its sidecar dequant) stays under _lock so the gathered tier view is atomic, as in the reference
            self._stage_disk(layer, [(seq, c) for seq, chunks in items
                                     for c in chunks],
                             nbytes=(self._disk_read_bytes()
                                     if self.disk_sidecar
                                     else self._transit_bytes()),
                             skip_pool=False)
            kg = np.zeros((B, nmax, self.chunk, self.kv_heads, self.head_dim),
                          self.dtype)
            vg = np.zeros_like(kg)
            for i, (seq, chunks) in enumerate(items):
                for j, c in enumerate(chunks):
                    key = (seq, layer, c)
                    self.access[seq, layer, c] += 1
                    if key in self._dev_k:
                        self._touch(key)
                        kg[i, j] = self._dev_k[key]
                        vg[i, j] = self._dev_v[key]
                        continue
                    self._record(seq, HOST, DEVICE, "kv",
                                 self._transit_bytes())
                    if to_device:
                        self._promote_device(key, self._host_k[key],
                                             self._host_v[key])
                    kg[i, j] = self._host_k[key]
                    vg[i, j] = self._host_v[key]
            return kg, vg, nsel

    # ------------------------------------------------------------------
    # Pooled path: device-resident slab, delta uploads, real codec
    # ------------------------------------------------------------------
    def _stage_disk(self, layer: int, keys: Sequence[Tuple[int, int]], *,
                    nbytes: float, skip_pool: bool,
                    retier: bool = False) -> Tuple[int, float]:
        """Coalesce disk→host reads for every key lacking a host copy: one
        gather per representation.  Sidecar-valid chunks move packed bytes
        (dequantized on the host, billed :meth:`_packed_bytes`); the rest
        read the fp16 replica, CRC-verified, and bill ``nbytes``.  A
        sidecar that fails its CRC (or stays unreadable past the retry
        budget) falls back to the replica on its own, billed
        ``kv_fallback``, and marks its sequence degraded.
        ``skip_pool``: pool residents need no host copy (else the legacy
        device tier's residents need none).  ``retier`` marks staged
        chunks HOST so a later fetch sees the copy instead of re-reading.
        Returns (chunks read, bytes billed); a lost replica raises
        :class:`ChunkLostError`."""
        need: List[Tuple[int, int, int]] = []   # (billed seq, row, c)
        seen = set()
        pool = self.pools[layer]
        for seq, c in keys:
            key = (seq, layer, c)
            if key in seen:
                continue
            seen.add(key)
            if skip_pool and pool is not None and (seq, c) in pool.slot_of:
                continue
            if not skip_pool and key in self._dev_k:
                continue
            if key in self._host_k and self.tier[seq, layer, c] != DISK:
                continue
            need.append((seq, seq, c))
        billed = 0.0
        need_q = [e for e in need if self._sidecar_ok(e[1], layer, e[2])]
        need_fp = [e for e in need if not self._sidecar_ok(e[1], layer,
                                                           e[2])]
        # sidecar group first: a CRC-quarantined key degrades into the
        # fp16 group below and bills kv_fallback — the read that actually
        # happened, at its full-chunk cost
        fallback: Set[Tuple[int, int]] = set()
        if need_q:
            per_chunk = self._packed_bytes()
            try:
                blk, bad = self._read_sidecar(
                    layer, [(p, c) for _, p, c in need_q])
            except DiskIOExhausted:
                blk, bad = None, set(range(len(need_q)))
            for i, (seq, p, c) in enumerate(need_q):
                if blk is None or i in bad:
                    fallback.add((p, c))
                    need_fp.append((seq, p, c))
                    continue
                self._record(seq, DISK, HOST, "kv", per_chunk)
                billed += per_chunk
                key = (p, layer, c)
                self._host_k[key], self._host_v[key] = blk[i][0], blk[i][1]
                if retier:
                    self.tier[p, layer, c] = HOST
        lost: List[Tuple[int, int, int]] = []
        if need_fp:
            try:
                blk, bad = self._replica_read_verified(layer, need_fp)
            except DiskIOExhausted:
                # unreadable past the retry budget: the whole gather is
                # disk-lost — the engine recomputes the span from the
                # prompt or fails just the affected sequence
                blk, bad = None, set(range(len(need_fp)))
                for _, p, c in need_fp:
                    self._disk_lost.add((p, layer, c))
            for i, (seq, p, c) in enumerate(need_fp):
                if blk is None or i in bad:
                    lost.append((seq, p, c))
                    continue
                if (p, c) in fallback:
                    self.degraded_seqs.add(seq)
                    self._record(seq, DISK, HOST, "kv_fallback", nbytes)
                else:
                    self._record(seq, DISK, HOST, "kv", nbytes)
                billed += nbytes
                key = (p, layer, c)
                self._host_k[key], self._host_v[key] = blk[i][0], blk[i][1]
                if retier:
                    self.tier[p, layer, c] = HOST
        if lost:
            raise ChunkLostError(layer, lost)
        return len(need), billed

    @worker_thread
    def stage_host(self, layer: int,
                   chunks_by_seq: Dict[int, Sequence[int]]) -> int:
        """Speculative disk→host staging (DTP prefetch): pulls predicted
        chunks off disk and re-tiers them HOST so the true fetch finds
        them; a wrong prediction costs only this read.  Faults are
        swallowed here by design: a lost or unreadable chunk is left for
        the decode thread's own fetch to detect and recover (the disk-lost
        marks this call made are kept).  Returns the number of chunks
        staged."""
        with self._lock:
            keys = [(seq, c) for seq, chunks in chunks_by_seq.items()
                    for c in chunks]
            try:
                n, _ = self._stage_disk(layer, keys,
                                        nbytes=self._disk_read_bytes(),
                                        skip_pool=True, retier=True)
            except (ChunkLostError, DiskIOExhausted):
                return 0
            return n

    def _pack_upload(self, kv_comp: np.ndarray):
        """The codec part of a delta upload, on the device: each plane of
        the (n, planes, c, Hkv, hd) chunks packed on the host and stacked
        plane-major (the K planes, then the V planes), as kernel B3 takes
        them; None when there is no codec part."""
        if not len(kv_comp):
            return None
        packed = [compression.quantize_chunks(kv_comp[:, pl],
                                              self.transit_codec)
                  for pl in range(self.planes)]
        data = torch.from_numpy(np.concatenate([d for d, _ in packed]))
        scale = torch.from_numpy(np.concatenate([s for _, s in packed]))
        return data.to(self.device), scale.to(self.device)

    @decode_thread_only
    def fetch_chunks_pooled(self, layer: int,  # leolint: waive[locklint] reason=decode-thread pooled fetch: the slab update runs under _lock so tier tables stay consistent with residency; it is an eager in-place device write, not a compiled dispatch
                            chunks_by_seq: Dict[int, Sequence[int]], *,
                            pad_to: Optional[int] = None,
                            theta: float = 1.0
                            ) -> Tuple[np.ndarray, np.ndarray, FetchStats]:
        """Delta promotion into the layer's device slab.

        Chunks already pool-resident cost NOTHING; only the missing delta
        is stacked and written into freshly-allocated slots.  With
        ``real_codec``, the first ``round(theta * missing)`` chunks cross
        host→device as packed int4/int8 + f32 scales and are dequantized
        on the device (kernel B3); the rest go as fp16.  Billing is the
        actual payload per chunk.  Deferred prefill placements
        (``pool.pending_place``) take slots first and are written in the
        same update as plain rows, billed nothing.

        Returns (slots, nsel, stats): slots (B, pad_to) int32 indices into
        ``pools[layer]`` (padding rows point at slot 0 — the engine masks
        them), nsel (B,) valid counts.  Rows follow dict order."""
        if not self.use_pool:
            raise ValueError(
                "fetch_chunks_pooled requires a pooled store — construct "
                "TieredKVStore(use_pool=True, ...) or use fetch_chunks / "
                "fetch_chunks_batch on the legacy host-assembled path")
        with self._lock:
            st = FetchStats()
            pool = self.pools[layer]
            items = list(chunks_by_seq.items())
            B = len(items)
            nsel = np.array([len(c) for _, c in items], np.int32)
            nmax = int(pad_to if pad_to is not None
                       else (nsel.max() if B else 0))

            t0 = time.perf_counter()
            st.disk_reads, st.disk_bytes = self._stage_disk(
                layer, [(seq, c) for seq, chunks in items for c in chunks],
                nbytes=self._disk_read_bytes(), skip_pool=True)
            st.gather_s = time.perf_counter() - t0

            slots = np.zeros((B, nmax), np.int32)
            pinned = {(seq, c) for seq, chunks in items for c in chunks}
            # fold deferred prefill placements (admission on a worker) into
            # this round's slab update — unbilled; the decode thread is the
            # only slab writer, so attention never races a placement
            place_keys: List[Tuple[int, int]] = []
            place_slots: List[int] = []
            place_kv: List[np.ndarray] = []
            for key, kv in list(pool.pending_place.items()):
                pool.pending_place.pop(key)
                if not pool.free and all(v in pinned for v in pool.slot_of):
                    continue           # pool pinned solid: stays on host
                slot, evicted = pool.alloc(key, pinned)
                if evicted is not None:
                    self.tier[evicted[0], layer, evicted[1]] = HOST
                self.tier[key[0], layer, key[1]] = DEVICE
                place_keys.append(key)
                place_slots.append(slot)
                place_kv.append(kv)
            missing: List[Tuple[int, int, int, int]] = []
            for i, (seq, chunks) in enumerate(items):
                for j, c in enumerate(chunks):
                    self.access[seq, layer, c] += 1
                    slot = pool.lookup((seq, c))
                    if slot is None:
                        missing.append((i, j, seq, c))
                    else:
                        slots[i, j] = slot
                        st.hits += 1
            t1 = time.perf_counter()
            fresh: Dict[Tuple[int, int], int] = {}

            def scrub_partial():
                # residency must never point at a slab row the scatter did
                # not write: return the half-uploaded slots (host copies
                # and replicas are intact) and put the deferred placements
                # back for the next fetch
                for pk, slot in [*fresh.items(),
                                 *zip(place_keys, place_slots)]:
                    if pool.slot_of.get(pk) == slot:
                        pool.slot_of.pop(pk, None)
                        pool.free.append(slot)
                    self.tier[pk[0], layer, pk[1]] = HOST
                pool.pending_place.update(zip(place_keys, place_kv))

            if missing:
                up_keys: List[Tuple[int, int]] = []
                try:
                    for i, j, seq, c in missing:
                        slot, evicted = pool.alloc((seq, c), pinned)
                        if evicted is not None:
                            self.tier[evicted[0], layer, evicted[1]] = HOST
                        self.tier[seq, layer, c] = DEVICE
                        fresh[(seq, c)] = slot
                        up_keys.append((seq, c))
                        slots[i, j] = slot
                    kv_stack = np.stack(
                        [self._plane_stack(self._host_k[(s, layer, c)],
                                           self._host_v[(s, layer, c)])
                         for s, c in up_keys])  # (m, planes, c, Hkv, hd)
                    m = len(up_keys)
                    n_comp = int(round(min(1.0, max(0.0, theta)) * m)) \
                        if self.real_codec else 0
                    # deferred placements ride along as plain rows after
                    # the delta; B3's slot list stays the codec part
                    self._bill_flushed_rows(pool.scatter(
                        [fresh[k] for k in up_keys] + place_slots,
                        np.concatenate([kv_stack[n_comp:], *(
                            [np.stack(place_kv)] if place_kv else [])]),
                        self._pack_upload(kv_stack[:n_comp]),
                        codec=self.transit_codec, impl=self.impl))
                except BaseException:
                    scrub_partial()
                    raise
                per_comp = self._packed_bytes() if self.real_codec \
                    else self._transit_bytes()
                per_plain = float(self.chunk_bytes) if self.real_codec \
                    else self._transit_bytes()
                for idx, (seq, _c) in enumerate(up_keys):
                    nb = per_comp if idx < n_comp else per_plain
                    self._record(seq, HOST, DEVICE, "kv", nb)
                    st.upload_bytes += nb
                st.uploads = m
                st.compressed = n_comp
                self.codec_uploads += n_comp
                self.plain_uploads += m - n_comp
            elif place_slots:
                try:
                    self._bill_flushed_rows(
                        pool.scatter(place_slots, np.stack(place_kv)))
                except BaseException:
                    scrub_partial()
                    raise
            elif pool.pending:
                self._bill_flushed_rows(pool.scatter([], None))
            st.upload_s = time.perf_counter() - t1
            return slots, nsel, st

    def pool_stats(self) -> Dict[str, float]:
        """Aggregate pool residency counters across layers."""
        pools = [p for p in self.pools if p is not None]
        hits = sum(p.hits for p in pools)
        misses = sum(p.misses for p in pools)
        uploads = sum(p.uploads for p in pools)
        return {"hits": hits, "misses": misses, "uploads": uploads,
                "hit_rate": hits / max(1, hits + misses),
                "slots": pools[0].n_slots if pools else 0,
                "free_slots": (min(len(p.free) for p in pools)
                               if pools else 0),
                "resident": (max(len(p.slot_of) for p in pools)
                             if pools else 0)}

    # ------------------------------------------------------------------
    @decode_thread_only
    def demote(self, layer: int, chunks: Sequence[int], to: str = HOST, *,
               seq: int = 0) -> None:
        """Eviction is free toward disk (replicas, §4.3): no bytes move."""
        with self._lock:
            for c in chunks:
                key = (seq, layer, c)
                self._dev_k.pop(key, None)
                self._dev_v.pop(key, None)
                self._lru.pop(key, None)
                if self.pools[layer] is not None:
                    self.pools[layer].evict((seq, c))
                if to == DISK:
                    self._host_k.pop(key, None)
                    self._host_v.pop(key, None)
                self.tier[seq, layer, c] = to

    # ------------------------------------------------------------------
    # Whole-sequence preemption (overload control)
    # ------------------------------------------------------------------
    @decode_thread_only
    def swap_out_seq(self, seq: int) -> int:
        """Demote a preempted sequence's whole hot working set.

        The disk replica is write-through (appends land every round), so
        swap-out moves no payload bytes: like :meth:`demote` it releases
        resources — the pool slots and legacy device entries free, and
        every host copy drops.  Each chunk that had a host copy is billed
        as a zero-byte ``kv_swapout`` op (the ledger records the op
        without claiming traffic that never crossed).  The resident set is
        remembered so :meth:`swap_in_seq` restores exactly it.  The caller
        (the engine) fences the sequence's write-behind ingest first.
        Unlike :meth:`clear_seq` this keeps the slot's access counts,
        abstracts, logs and CRC state: the sequence is paused, not retired.
        Returns the number of chunks swapped out."""
        with self._lock:
            resident: Dict[int, List[int]] = {}
            n = 0
            for layer in range(self.n_layers):
                pool = self.pools[layer]
                cs = {c for (s, l, c) in self._host_k
                      if s == seq and l == layer}
                cs |= {c for (s, l, c) in self._dev_k
                       if s == seq and l == layer}
                if pool is not None:
                    cs |= {c for (s, c) in pool.slot_of if s == seq}
                    pool.evict_seq(seq)
                for c in sorted(cs):
                    key = (seq, layer, c)
                    host = key in self._host_k
                    self._host_k.pop(key, None)
                    self._host_v.pop(key, None)
                    self._dev_k.pop(key, None)
                    self._dev_v.pop(key, None)
                    self._lru.pop(key, None)
                    self.tier[seq, layer, c] = DISK
                    if host:
                        self._record(seq, HOST, DISK, "kv_swapout", 0.0)
                if cs:
                    resident[layer] = sorted(cs)
                    n += len(cs)
            self._swapped[seq] = resident
            self.seq_swapouts += 1
            return n

    @decode_thread_only
    def swap_in_seq(self, seq: int) -> int:
        """Re-stage a suspended sequence's remembered working set on the
        host off the disk replica (CRC-verified coalesced read per layer;
        ``kv_swapin`` bills ``chunk_bytes`` a chunk — these bytes really
        cross).  The next pooled fetch uploads them as any host chunk.

        A chunk that fails verification stays disk-tier and is marked
        lost, so the next decode fetch routes it through the engine's
        recompute or containment path like any other disk-lost chunk; an
        exhausted retry budget likewise leaves the layer to lazy re-reads
        instead of failing the resume.  Returns the number of chunks
        restored on the host."""
        with self._lock:
            resident = self._swapped.pop(seq, {})
            n = 0
            for layer, cs in resident.items():
                entries = [(seq, seq, c) for c in cs]
                try:
                    blk, lost = self._replica_read_verified(layer, entries)
                except (TransientDiskError, DiskIOExhausted):
                    # stays disk-tier: the decode fetch re-reads it (and
                    # retries or degrades) through its containment path
                    continue
                for i, c in enumerate(cs):
                    if i in lost:
                        continue
                    key = (seq, layer, c)
                    self._host_k[key], self._host_v[key] = \
                        blk[i][0], blk[i][1]
                    self.tier[seq, layer, c] = HOST
                    self._record(seq, DISK, HOST, "kv_swapin",
                                 float(self.chunk_bytes))
                    n += 1
            self.seq_swapins += 1
            return n

    @any_thread
    def host_bytes(self) -> int:
        """Live host-tier copy bytes."""
        with self._lock:
            return len(self._host_k) * self.chunk_bytes

    def device_bytes(self) -> int:
        """Chunk bytes resident in the device tier (legacy dicts and pool
        slots)."""
        resident = len(self._dev_k) + sum(
            len(p.slot_of) for p in self.pools if p is not None)
        return resident * self.chunk_bytes

    def append_token(self, layer: int, pos: int, k_new: np.ndarray,
                     v_new: np.ndarray, *, seq: int = 0) -> None:
        """Decode-step cache append: update chunk + abstract in place."""
        self.append_tokens_batch(layer, np.asarray([pos]), k_new[None],
                                 v_new[None], seqs=[seq])

    @decode_thread_only
    def append_tokens_batch(self, layer: int, positions: np.ndarray,
                            k_news: np.ndarray, v_news: np.ndarray, *,
                            seqs: Sequence[int]) -> None:
        """One round's appends for a layer: vectorized disk writes +
        abstract updates, host and legacy-device mirror updates, and the
        pool rows queued for the next slab flush.  positions: (B,),
        k_news/v_news: (B, Hkv, hd) (f32 or the store dtype), seqs: (B,).
        An append stales the chunk's sidecar scales and PQ codes: both are
        invalidated until the requant sweep repacks the quiet chunk."""
        with self._lock:
            sq = np.asarray(list(seqs), np.int64)
            pos = np.asarray(positions, np.int64)
            cs, offs = pos // self.chunk, pos % self.chunk
            kd = k_news.astype(self.dtype)
            vd = v_news.astype(self.dtype)
            self._disk[sq, layer, cs, 0, offs] = kd
            self._disk[sq, layer, cs, 1, offs] = vd
            if self._crc_state is not None:
                # append-dirtied: the replica changed under its checksum
                # (served unverified until the sweep re-checksums it)
                self._crc_state[sq, layer, cs] = _CRC_DIRTY
            if self.disk_sidecar:
                # the chunk's per-channel scales no longer cover the new
                # row: reads fall back to the lossless fp16 replica
                self._sidecar_valid[sq, layer, cs] = False
            if self.pq:
                # the appended row is not in the codes: importance falls
                # back to the chunk's min/max box — bitwise the minmax
                # score — until the sweep re-encodes the quiet chunk
                self._pq_valid[sq, layer, cs] = False
            if self.disk_sidecar or self.pq:
                for i in range(len(sq)):
                    key = (int(sq[i]), layer, int(cs[i]))
                    self._requant_pending[key] = self._sweep_round
                    self._chunk_version[key] += 1
            self._abs_km[sq, layer, cs] = np.maximum(
                self._abs_km[sq, layer, cs], k_news)
            self._abs_kn[sq, layer, cs] = np.minimum(
                self._abs_kn[sq, layer, cs], k_news)
            row_bytes = self.row_bytes
            pool = self.pools[layer]
            for i in range(len(sq)):
                seq, c, off = int(sq[i]), int(cs[i]), int(offs[i])
                key = (seq, layer, c)
                if key in self._host_k:
                    self._host_k[key][off] = kd[i]
                    self._host_v[key][off] = vd[i]
                if key in self._dev_k:
                    self._dev_k[key][off] = kd[i]
                    self._dev_v[key][off] = vd[i]
                if pool is not None and (seq, c) in pool.slot_of:
                    # H2D billing happens when the flush carries the row
                    pool.queue_row((seq, c), off,
                                   self._plane_stack(kd[i], vd[i]))
                self._record(seq, HOST, DISK, "kv_append", row_bytes)

    # ------------------------------------------------------------------
    # Requant sweep: sidecar repack and PQ re-encode of quiet chunks
    # ------------------------------------------------------------------
    @decode_thread_only
    def requant_sweep(self, executor=None) -> int:
        """Advance the sweep clock one decode round and repack (sidecar)
        and re-encode (PQ codes) every append-dirtied chunk that stayed
        quiet for at least one FULL round since its last append (the live
        tail chunk refreshes its entry every round, so it is never
        repacked while appends land in it).  With ``executor`` the work
        runs write-behind on that worker; a concurrent append (or slot
        reuse) bumps the chunk's version and aborts that chunk.  Returns
        the number of chunks submitted."""
        if not (self.disk_sidecar or self.pq):
            return 0
        # prune landed repacks so the in-flight list stays bounded,
        # surfacing a worker exception instead of swallowing it: the whole
        # list is pruned first, then the first failure re-raises
        still, first = [], None
        for f in self._requant_futs:
            if f.done():
                try:
                    f.result()
                except BaseException as e:
                    if first is None:
                        first = e
            else:
                still.append(f)
        self._requant_futs = still
        if first is not None:
            raise first
        with self._lock:
            self._sweep_round += 1
            r = self._sweep_round
            ready = [key for key, rr in self._requant_pending.items()
                     if rr < r - 1]
            for key in ready:
                self._requant_pending.pop(key)
            vers = {key: self._chunk_version[key] for key in ready}
        if not ready:
            return 0
        if executor is None:
            self._requant_chunks(ready, vers)
        else:
            self._requant_futs.append(
                executor.submit(self._requant_chunks, ready, vers))
        return len(ready)

    @worker_thread
    def _requant_chunks(self, keys: List[Tuple[int, int, int]],
                        vers: Dict[Tuple[int, int, int], int]) -> None:
        """Repack each chunk's fp16 replica into its int sidecar and/or
        re-encode its PQ codes (kernel B4) off the current replica bytes.
        Quantization and the encode run OUTSIDE the locks on private
        copies; the write re-validates the chunk's version under the lock,
        so a repack never marks a sidecar (or codes) valid over rows it
        did not see."""
        for seq, layer, c in keys:
            key = (seq, layer, c)
            with self._lock:
                if self._chunk_version[key] != vers[key]:
                    continue            # a newer append re-dirtied it
                planes = [np.array(self._disk[seq, layer, c, pl])
                          for pl in range(self.planes)]
                # the repack READS the fp16 replica off disk before it
                # writes the packed sidecar / fresh codes back — both
                # directions bill
                self._record(seq, DISK, HOST, "sidecar_repack_read",
                             float(self.chunk_bytes))
            packed = None
            if self.disk_sidecar:
                packed = [compression.quantize_chunks(p[None],
                                                      self.transit_codec)
                          for p in planes]
            codes_c = None
            if self.pq:
                with self._pq_lock:
                    cb = self._pq_cb[layer].copy()
                codes_c = pq_encode(
                    planes[0].reshape(-1, self.head_dim).astype(np.float32),
                    cb, impl=self.impl, device=self.device).reshape(
                        self.chunk, self.kv_heads, self.pq_m)
            # the read already paid for the whole replica: refresh its CRC
            # (append-dirtied -> valid) and checksum the fresh derived bytes
            rep_crc = self._crc32(np.stack(planes)) \
                if self._crc is not None else None
            side_crc = None
            if packed is not None and self._q_crc is not None:
                side_crc = self._sidecar_crc(
                    np.stack([pd[0] for pd, _ in packed]),
                    np.stack([ps[0] for _, ps in packed]))
            codes_crc = self._crc32(codes_c) \
                if codes_c is not None and self._pq_crc is not None else None
            with self._lock:
                if self._chunk_version[key] != vers[key]:
                    continue            # raced an append mid-repack
                if packed is not None:
                    for pl, (pd, ps) in enumerate(packed):
                        self._disk_q[seq, layer, c, pl] = pd[0]
                        self._disk_scale[seq, layer, c, pl] = ps[0]
                    self._sidecar_valid[seq, layer, c] = True
                    if side_crc is not None:
                        self._q_crc[seq, layer, c] = side_crc
                    self.sidecar_repacks += 1
                    self._record(seq, HOST, DISK, "sidecar_repack",
                                 self._packed_bytes())
                if rep_crc is not None:
                    self._crc[seq, layer, c] = rep_crc
                    self._crc_state[seq, layer, c] = _CRC_VALID
                if codes_c is not None:
                    self._pq_codes[seq, layer, c] = codes_c
                    self._pq_valid[seq, layer, c] = True
                    if codes_crc is not None:
                        self._pq_crc[seq, layer, c] = codes_crc
                    self.pq_reencodes += 1
                    self._record(seq, HOST, DISK, "pq_codes_write",
                                 float(self.pq_bytes))

    @any_thread
    def requant_fence(self) -> None:
        """Drain in-flight background repacks (shutdown / test
        ordering).  Every future is awaited even when one raises; the
        first failure re-raises."""
        futs, self._requant_futs = self._requant_futs, []
        first: Optional[BaseException] = None
        for f in futs:
            try:
                f.result()
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None:
            raise first

    # ------------------------------------------------------------------
    @decode_thread_only
    def clear_seq(self, seq: int) -> None:
        """Retire a sequence: free its hot-tier entries so the slot can be
        reused; its traffic log moves to ``retired_logs``."""
        with self._lock:
            for d in (self._host_k, self._host_v, self._dev_k, self._dev_v,
                      self._lru):
                for key in [k for k in d if k[0] == seq]:
                    d.pop(key, None)
            for pool in self.pools:
                if pool is not None:
                    pool.evict_seq(seq)
            self._abs_km[seq] = -np.inf
            self._abs_kn[seq] = np.inf
            self.tier[seq] = HOST
            self.access[seq] = 0.0
            self._sidecar_valid[seq] = False
            if self._pq_valid is not None:
                self._pq_valid[seq] = False
            # retire the slot's requant state: pending entries drop and the
            # version bump aborts any in-flight repack of the old data
            for key in [k for k in self._requant_pending if k[0] == seq]:
                self._requant_pending.pop(key)
            for key in [k for k in self._chunk_version if k[0] == seq]:
                self._chunk_version[key] += 1
            if seq in self.seq_logs:
                self.retired_logs.append(self.seq_logs.pop(seq))
            # fault-domain state is per slot: a reused slot inherits no
            # swap record, degradation or lost-chunk marks
            self._swapped.pop(seq, None)
            self.degraded_seqs.discard(seq)
            self._disk_lost = {k for k in self._disk_lost if k[0] != seq}
            if self._crc_state is not None:
                self._crc_state[seq] = _CRC_NONE

    # ------------------------------------------------------------------
    # Fault-domain recovery
    # ------------------------------------------------------------------
    @any_thread
    def restore_chunk(self, layer: int, seq: int, c: int,
                      k_rows: np.ndarray, v_rows: np.ndarray) -> None:
        """Re-land one disk-lost chunk from recomputed prompt K/V.

        ``k_rows``/``v_rows`` are the chunk's (chunk, Hkv, hd) rows
        (possibly short for the tail chunk — zero-padded here exactly as
        ingest pads, so the replica CRC matches a fresh ingest).  Rebuilds
        the fp16 replica, the abstracts and the replica CRC; the packed
        sidecar and the PQ codes stay quarantined for the requant sweep to
        rebuild lazily off the restored replica.  Bumps the chunk's
        version so that an in-flight repack of the old bytes aborts.
        Billed as ``kv_recompute``."""
        kc = np.asarray(k_rows, dtype=self.dtype)
        vc = np.asarray(v_rows, dtype=self.dtype)
        if kc.shape[0] < self.chunk:
            pad = np.zeros((self.chunk - kc.shape[0],) + kc.shape[1:],
                           dtype=self.dtype)
            kc = np.concatenate([kc, pad], axis=0)
            vc = np.concatenate([vc, pad], axis=0)
        with self._lock:
            self._disk[seq, layer, c, 0] = kc
            self._disk[seq, layer, c, 1] = vc
            self._abs_km[seq, layer, c] = kc.max(axis=0)
            self._abs_kn[seq, layer, c] = kc.min(axis=0)
            self._sidecar_valid[seq, layer, c] = False
            if self._pq_valid is not None:
                # restored bytes carry no fresh codes: min/max serves the
                # chunk until the sweep re-encodes it
                self._pq_valid[seq, layer, c] = False
                self._requant_pending.setdefault((seq, layer, c),
                                                 self._sweep_round)
            if (seq, layer, c) in self._chunk_version:
                self._chunk_version[(seq, layer, c)] += 1
            if self._crc is not None:
                self._crc[seq, layer, c] = self._crc32(
                    self._plane_stack(kc, vc))
                self._crc_state[seq, layer, c] = _CRC_VALID
            self._disk_lost.discard((seq, layer, c))
            self.fault_counters["chunks_recomputed"] += 1
            self._record(seq, HOST, DISK, "kv_recompute",
                         float(self.chunk_bytes))

    @any_thread
    def disk_lost_keys(self) -> Set[Tuple[int, int, int]]:
        """Snapshot of the (row, layer, chunk) keys marked disk-lost."""
        with self._lock:
            return set(self._disk_lost)

    @any_thread
    def fault_stats(self) -> Dict[str, float]:
        """Fault-domain counters (scheduler-facing)."""
        with self._stats_lock:
            out = {k: float(v) for k, v in self.fault_counters.items()}
        with self._lock:
            out["disk_lost"] = float(len(self._disk_lost))
            out["degraded_seqs"] = float(len(self.degraded_seqs))
            out["pq_reencodes"] = float(self.pq_reencodes)
        return out

    def tier_bytes(self) -> Dict[str, float]:
        """Bytes moved so far, by (src, dst) pair."""
        out: Dict[str, float] = defaultdict(float)
        for (src, dst, _kind), v in self.log.bytes.items():
            out[f"{src}->{dst}"] += v
        return dict(out)

    def close(self) -> None:
        """Drain in-flight writes and repacks, then drop the memmaps, which
        flushes them (best-effort: a failed worker must not block shutdown
        of the survivors)."""
        try:
            self.ingest_fence_all()
        except Exception:
            pass
        try:
            self.requant_fence()
        except Exception:
            pass
        self._disk = self._disk_q = self._disk_scale = None
        self._crc = self._crc_state = self._q_crc = None
        self._pq_codes = self._pq_codebook = self._pq_crc = None
