"""DTP — Dynamic Three-tier Pipeline (paper §4.4).

Two parts:

* :func:`optimal_theta` — the paper's dynamic-compression balance: choose the
  compressed fraction θ of the D bytes to transfer so that transfer hides
  exactly under compute:  T0 + (D(1-θ) + Dθδ)/B  =  Tc + t(Dθ),
  with t(x) = κx the decompression cost.  Solving for θ:

      θ* = (Tc + T0' ... )  — closed form below, clamped to [0, 1].

* :class:`PipelineSchedule` — an event-timeline builder for the three-tier
  layer pipeline: disk→CPU abstract loads, CPU evaluation, CPU→GPU selected-KV
  transfer, GPU layer compute; with per-layer overlap (the paper's Fig. 13).
  The discrete-event serving simulator and the Fig.13/16 benchmarks use it.

* :func:`prefill_schedule` — the ADMISSION-side counterpart: per-layer
  prefill compute vs the layer's tier writes (disk replica + abstract,
  optionally packed through the transit codec).  Serial admission stalls
  compute behind every write; write-behind admission drains the writes on
  the disk link under the remaining layers' compute, so TTFT collapses to
  the compute chain plus whatever write tail outlives it — the model the
  fig13 TTFT-breakdown benchmark checks the live engine against.

* :func:`chunked_admission_model` — the CHUNKED-admission trade: splitting
  a prompt's prefill into fixed chunks advanced between decode rounds
  bounds the running batch's max round gap at the per-round chunk budget
  (vs the whole prefill) while TTFT stretches by the interleaved rounds —
  the fig13 mixed-length benchmark measures the live scheduler against it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def optimal_theta(D: float, B: float, delta: float, T0: float, Tc: float,
                  kappa: float) -> float:
    """Paper §4.4: smallest θ∈[0,1] hiding transfer under compute.

    Latency-if-uncompressed must satisfy
        T0 + (D(1-θ) + Dθδ)/B <= Tc + κDθ.
    LHS decreases in θ (δ<1), RHS increases, so the equality point is the
    minimum compression that removes the GPU bubble:
        θ* = (T0 + D/B - Tc) / (D(1-δ)/B + κD).
    θ<0 → no compression needed; θ>1 → even full compression can't hide it
    (compress everything; the residual bubble shows in the timeline).
    """
    if D <= 0:
        return 0.0
    denom = D * (1.0 - delta) / B + kappa * D
    if denom <= 0:
        return 0.0
    theta = (T0 + D / B - Tc) / denom
    return float(min(1.0, max(0.0, theta)))


def transfer_time(D: float, theta: float, delta: float, B: float) -> float:
    return (D * (1.0 - theta) + D * theta * delta) / B


def theta_from_measured(upload_bytes: float, disk_bytes: float,
                        compute_s: float, bw: "TierBW",
                        delta: Optional[float] = None) -> float:
    """Per-layer θ from the live engine's measured round costs (§4.4).

    ``upload_bytes``: last round's host→device delta for the layer (the D
    the codec can shrink); ``disk_bytes``: bytes staged off disk for the
    layer (serial prefix T0); ``compute_s``: measured per-layer attention
    window.  The engine calls this every round so θ tracks the working set
    as residency warms up — fully pool-resident layers get θ=0 for free.
    """
    return optimal_theta(upload_bytes, bw.pcie,
                         bw.delta if delta is None else delta,
                         disk_bytes / bw.disk, compute_s, bw.kappa)


@dataclass
class PrefillLayerCost:
    """Per-layer admission costs: prefill compute + tier-write bytes."""
    compute: float                 # GPU prefill compute for the layer
    replica_bytes: float           # host->disk replica + abstract bytes
                                   # (packed bytes when the sidecar is on)


def prefill_schedule(layers: Sequence["PrefillLayerCost"], disk_bw: float, *,
                     write_behind: bool = True) -> "Timeline":
    """Admission (TTFT) timeline: layer-streamed prefill vs serial ingest.

    Serial: each layer's replica/abstract writes stall the admission chain
    (compute → write → next layer).  Write-behind: writes queue on the disk
    link as soon as their layer's compute finishes and drain under the
    remaining layers' compute; the first token is ready at the end of the
    compute chain (``Timeline.compute[-1][1]``), while ``makespan`` extends
    to the last write landing — the window the completion fence covers.
    """
    tl = Timeline()
    t = 0.0
    disk_free = 0.0
    for lc in layers:
        c0, c1 = t, t + lc.compute
        w = lc.replica_bytes / disk_bw
        if write_behind:
            x0 = max(c1, disk_free)
            x1 = x0 + w
            disk_free = x1
            t = c1
        else:
            x0, x1 = c1, c1 + w
            t = x1
        tl.compute.append((c0, c1))
        tl.transfer.append((x0, x1))
        tl.thetas.append(0.0)
    return tl


def chunked_admission_model(chunk_s: float, n_chunks: int, round_s: float,
                            chunks_per_round: int) -> Dict[str, float]:
    """Analytic model of CHUNKED admission interleaved with decode rounds.

    Whole-prompt admission runs all ``n_chunks`` prefill chunks back to
    back between two decode rounds: the running batch sees ONE decode gap
    of ``round_s + n_chunks * chunk_s`` and TTFT is the prefill chain.
    Chunked admission advances at most ``chunks_per_round`` chunks per
    round, bounding the decode gap at ``round_s + chunks_per_round *
    chunk_s`` while TTFT stretches by the decode rounds now interleaved
    into the prefill.  The fig13 mixed-length benchmark checks the live
    scheduler against exactly this trade: bounded stall, modest TTFT tax.
    """
    assert chunks_per_round >= 1
    interleaved = max(0, -(-n_chunks // chunks_per_round) - 1)
    return {
        "ttft_whole_s": n_chunks * chunk_s,
        "ttft_chunked_s": n_chunks * chunk_s + interleaved * round_s,
        "max_round_gap_whole_s": round_s + n_chunks * chunk_s,
        "max_round_gap_chunked_s": round_s + min(n_chunks, chunks_per_round)
        * chunk_s,
        "interleaved_rounds": float(interleaved),
    }


@dataclass
class LayerCost:
    """Per-layer per-step costs (seconds / bytes) for the pipeline model."""
    compute: float                 # GPU layer compute time
    eval_cpu: float                # importance evaluation on CPU
    abstract_bytes: float          # disk->CPU abstract traffic
    kv_bytes_cpu: float            # CPU->GPU selected KV (resident in CPU)
    kv_bytes_disk: float           # disk->CPU->GPU selected KV (cold)


@dataclass
class TierBW:
    """Tier link bandwidths (bytes/s) + decompression throughput."""
    pcie: float = 16e9             # CPU <-> GPU
    disk: float = 3.5e9            # disk -> CPU (sustained)
    kappa: float = 1.0 / 80e9      # s per byte decompressed on GPU
    delta: float = 0.25 + 4 / 128  # int4 codec ratio incl. scales


@dataclass
class Timeline:
    """Per-layer event spans; all times absolute seconds."""
    compute: List[Tuple[float, float]] = field(default_factory=list)
    transfer: List[Tuple[float, float]] = field(default_factory=list)
    evaluate: List[Tuple[float, float]] = field(default_factory=list)
    thetas: List[float] = field(default_factory=list)

    @property
    def makespan(self) -> float:
        ends = [e for spans in (self.compute, self.transfer, self.evaluate)
                for _, e in spans]
        return max(ends) if ends else 0.0

    @property
    def gpu_idle(self) -> float:
        busy = sum(e - s for s, e in self.compute)
        return self.makespan - busy


def schedule(layers: Sequence[LayerCost], bw: TierBW, *,
             pipelined: bool = True, dynamic_compression: bool = True,
             prefetch_depth: int = 1) -> Timeline:
    """Build the decode-step timeline.

    Non-pipelined: eval → transfer → compute strictly per layer.
    Pipelined (paper Fig. 13b/c): layer l computes while layer l+1 evaluates
    and transfers; dynamic compression picks θ per layer so transfer fits the
    compute window (Fig. 13c).
    """
    tl = Timeline()
    if not pipelined:
        t = 0.0
        for lc in layers:
            e0, e1 = t, t + lc.eval_cpu + lc.abstract_bytes / bw.disk
            D = lc.kv_bytes_cpu + lc.kv_bytes_disk
            x0 = e1
            x1 = x0 + lc.kv_bytes_disk / bw.disk + D / bw.pcie
            c0, c1 = x1, x1 + lc.compute
            tl.evaluate.append((e0, e1))
            tl.transfer.append((x0, x1))
            tl.compute.append((c0, c1))
            tl.thetas.append(0.0)
            t = c1
        return tl

    # pipelined: transfers for layer l+1 overlap compute of layer l
    gpu_free = 0.0
    xfer_done = [0.0] * (len(layers) + 1)
    eval_done = [0.0] * (len(layers) + 1)
    # layer 0's eval/transfer cannot overlap anything in this decode step
    for i, lc in enumerate(layers):
        # evaluation (CPU) for layer i starts as soon as the previous
        # layer's evaluation finished (CPU is serial across layers)
        e0 = eval_done[i]
        e1 = e0 + lc.eval_cpu + lc.abstract_bytes / bw.disk
        eval_done[i + 1] = e1

        D = lc.kv_bytes_cpu + lc.kv_bytes_disk
        compute_window = lc.compute   # the window we can hide under
        if dynamic_compression and D > 0:
            T0 = lc.kv_bytes_disk / bw.disk
            theta = optimal_theta(D, bw.pcie, bw.delta, T0, compute_window,
                                  bw.kappa)
        else:
            theta = 0.0
        xfer = (lc.kv_bytes_disk / bw.disk
                + transfer_time(D, theta, bw.delta, bw.pcie))
        decomp = bw.kappa * D * theta

        x0 = max(e1, xfer_done[i])
        x1 = x0 + xfer
        xfer_done[i + 1] = x1

        c0 = max(gpu_free, x1)
        c1 = c0 + lc.compute + decomp
        gpu_free = c1

        tl.evaluate.append((e0, e1))
        tl.transfer.append((x0, x1))
        tl.compute.append((c0, c1))
        tl.thetas.append(theta)
    return tl
