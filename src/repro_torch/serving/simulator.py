"""Discrete-event latency simulator — the paper's evaluation harness
(Figs. 6, 13, 15–19) rebuilt from first-principles bytes/flops/overlap.

No wall-clock measurements are taken: every number derives from the hardware
constants below (calibrated to the paper's testbed: RTX-4090-class GPU,
PCIe 4.0, ~7 GB/s NVMe) and the byte/evaluation counts implied by each
policy.  Policies:

  full          — move every token's KV every step (offloading lower bound)
  h2o           — token-level importance eval; all disk KV transits for
                  evaluation (paper's H2O-like baseline)
  h2o_chunked   — fixed-chunk eval (Quest-like): fewer evals, over-fetch
                  from imprecise chunks, still full-disk transit for eval
  prefetch      — h2o + layer-pipelined prefetch (InfiniGen-like)
  leoam_lka     — +LKA: only abstracts transit from disk for evaluation
  leoam_iakm    — +IAKM: adaptive tree evaluation counts + exact-size fetch
  leoam_all     — +DTP: three-tier pipeline + dynamic INT4 compression
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import pipeline as dtp
from repro_torch.core.desert import eval_cost
from repro_torch.core.tiers import lka_transfer_ratio


@dataclass(frozen=True)
class HWCfg:
    """Paper-testbed constants (§6.1: RTX-4090, i7-14700K, PCIe 4.0,
    800 GB NVMe with ~7 GB/s peak read)."""
    gpu_flops: float = 83e12        # RTX-4090 bf16/fp16 dense
    gpu_hbm_bw: float = 1.0e12
    pcie_bw: float = 16e9           # PCIe 4.0 x16 effective
    disk_bw: float = 7.0e9          # the paper's measured SSD read rate
    cpu_eval_flops: float = 100e9   # CPU importance-evaluation throughput
    decompress_kappa: float = 1.0 / 80e9   # s/byte GPU dequant
    int4_ratio: float = 0.25 + 4 / 128
    # FlexGen-style weight placement (§6.1 "store model weights across both
    # the CPU and GPU"): the CPU-resident fraction streams over PCIe every
    # layer and is the compute-side floor every policy shares.
    weight_gpu_frac: float = 0.70
    weight_dtype_bytes: int = 2


@dataclass(frozen=True)
class ServeCfg:
    batch: int = 1
    prompt: int = 8192
    output: int = 128
    importance_rate: float = 0.1
    chunk: int = 64
    kv_dtype_bytes: int = 2
    gpu_frac: float = 0.10          # fraction of KV resident on GPU
    cpu_frac: float = 0.50          # fraction on CPU (rest on disk)
    rho: float = 0.12               # important-token density (tree model)


@dataclass
class StepBreakdown:
    eval_s: float = 0.0
    transfer_s: float = 0.0
    compute_s: float = 0.0
    total_s: float = 0.0


def _layer_geometry(cfg: ArchConfig, scfg: ServeCfg) -> Dict[str, float]:
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    S = scfg.prompt
    kv_bytes_tok = 2 * Hkv * hd * scfg.kv_dtype_bytes       # K+V, one layer
    n_attn = sum(1 for k in cfg.layer_kinds() if k.startswith("attn"))
    params_layer = cfg.n_active_params() / max(cfg.n_layers, 1)
    return {"kv_bytes_tok": kv_bytes_tok, "n_attn": n_attn,
            "params_layer": params_layer, "S": S}


def decode_step_costs(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg,
                      policy: str) -> List[dtp.LayerCost]:
    """Per-layer costs for ONE decode step under a policy."""
    g = _layer_geometry(cfg, scfg)
    B, S = scfg.batch, g["S"]
    kv_tok = g["kv_bytes_tok"]
    n_sel = max(1, int(S * scfg.importance_rate))
    disk_frac = max(0.0, 1.0 - scfg.gpu_frac - scfg.cpu_frac)
    n_chunks = S // scfg.chunk

    # GPU compute: dense matmuls are bounded below by HBM weight streaming
    # AND by PCIe streaming of the CPU-resident weight fraction (FlexGen
    # placement) — the common floor all policies share.
    w_bytes = g["params_layer"] * hw.weight_dtype_bytes
    t_dense = max(2 * g["params_layer"] * B / hw.gpu_flops,
                  w_bytes / hw.gpu_hbm_bw,
                  w_bytes * (1.0 - hw.weight_gpu_frac) / hw.pcie_bw)
    t_attn = (n_sel * kv_tok * B) / hw.gpu_hbm_bw          # bandwidth-bound
    compute = t_dense + t_attn

    # evaluation cost + transit bytes by policy
    over_fetch = 1.0
    if policy == "full":
        evals = 0
        eval_flops = 0.0
        abstract_bytes = 0.0
        sel_tokens = S                                      # everything moves
    elif policy in ("h2o", "prefetch"):
        evals = S
        eval_flops = evals * cfg.hd * cfg.n_heads * 2 * B
        # all disk-resident KV must transit up for evaluation (paper §3.4)
        abstract_bytes = disk_frac * S * kv_tok * B
        sel_tokens = n_sel
    elif policy == "h2o_chunked":
        evals = n_chunks
        eval_flops = evals * cfg.hd * cfg.n_heads * 2 * B
        abstract_bytes = disk_frac * S * kv_tok * B
        over_fetch = 1.0 / 0.625                            # paper Fig. 5/10
        sel_tokens = n_sel
    elif policy in ("leoam_lka", "leoam_iakm", "leoam_all"):
        if policy == "leoam_lka":
            evals = n_chunks
            over_fetch = 1.0 / 0.625
        else:
            evals = eval_cost(S, optimal_m(S, scfg.rho), scfg.rho)
            over_fetch = 1.0                                # exact-size chunks
        eval_flops = evals * cfg.hd * cfg.n_heads * 2 * B
        # LKA: only abstracts transit from disk (r = alpha + 2/n')
        abstract_bytes = (disk_frac * S * kv_tok * B) * (2.0 / scfg.chunk)
        sel_tokens = n_sel
    else:
        raise ValueError(policy)

    eval_cpu = eval_flops / hw.cpu_eval_flops
    moved = sel_tokens * over_fetch * kv_tok * B
    kv_disk = moved * disk_frac
    kv_cpu = moved * (1.0 - scfg.gpu_frac) - kv_disk
    kv_cpu = max(kv_cpu, 0.0)

    costs = []
    for kind in cfg.layer_kinds():
        if not kind.startswith("attn"):
            costs.append(dtp.LayerCost(compute=t_dense, eval_cpu=0.0,
                                       abstract_bytes=0.0, kv_bytes_cpu=0.0,
                                       kv_bytes_disk=0.0))
        else:
            costs.append(dtp.LayerCost(compute=compute, eval_cpu=eval_cpu,
                                       abstract_bytes=abstract_bytes,
                                       kv_bytes_cpu=kv_cpu,
                                       kv_bytes_disk=kv_disk))
    return costs


def optimal_m(n: int, rho: float) -> int:
    from repro_torch.core.desert import optimal_chunk_count
    return optimal_chunk_count(n, rho)


def simulate_decode(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg,
                    policy: str) -> StepBreakdown:
    """One decode step's latency under the policy's overlap model."""
    layers = decode_step_costs(cfg, scfg, hw, policy)
    bw = dtp.TierBW(pcie=hw.pcie_bw, disk=hw.disk_bw,
                    kappa=hw.decompress_kappa, delta=hw.int4_ratio)
    pipelined = policy in ("prefetch", "leoam_all")
    dyn = policy == "leoam_all"
    tl = dtp.schedule(layers, bw, pipelined=pipelined,
                      dynamic_compression=dyn)
    out = StepBreakdown(
        eval_s=sum(e - s for s, e in tl.evaluate),
        transfer_s=sum(e - s for s, e in tl.transfer),
        compute_s=sum(e - s for s, e in tl.compute),
        total_s=tl.makespan)
    return out


def prefill_time(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg) -> float:
    """Compute-bound prefill + KV write-out to tiers."""
    flops = 2 * cfg.n_active_params() * scfg.prompt * scfg.batch
    g = _layer_geometry(cfg, scfg)
    kv_total = g["kv_bytes_tok"] * scfg.prompt * scfg.batch * g["n_attn"]
    disk_frac = max(0.0, 1.0 - scfg.gpu_frac - scfg.cpu_frac)
    t_write = kv_total * disk_frac / hw.disk_bw + kv_total * (
        1 - scfg.gpu_frac) / hw.pcie_bw
    return flops / hw.gpu_flops + t_write


def prefill_time_prefix(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg,
                        hit_frac: float) -> float:
    """Prefill time with a warm shared prefix covering ``hit_frac`` of the
    prompt (the live engine's content-addressable admission path).

    The warm span pays no prefill FLOPs and writes no tier bytes — its KV
    is adopted by reference — but the GPU-resident share of the adopted
    span must still be promoted over PCIe into the device pool.  At
    ``hit_frac == 0`` this is exactly :func:`prefill_time`.
    """
    assert 0.0 <= hit_frac <= 1.0, hit_frac
    cold = 1.0 - hit_frac
    flops = 2 * cfg.n_active_params() * scfg.prompt * scfg.batch * cold
    g = _layer_geometry(cfg, scfg)
    kv_total = g["kv_bytes_tok"] * scfg.prompt * scfg.batch * g["n_attn"]
    disk_frac = max(0.0, 1.0 - scfg.gpu_frac - scfg.cpu_frac)
    t_write = cold * (kv_total * disk_frac / hw.disk_bw
                      + kv_total * (1 - scfg.gpu_frac) / hw.pcie_bw)
    t_promote = hit_frac * kv_total * scfg.gpu_frac / hw.pcie_bw
    return flops / hw.gpu_flops + t_write + t_promote


def simulate_request(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg,
                     policy: str) -> Dict[str, float]:
    step = simulate_decode(cfg, scfg, hw, policy)
    pre = prefill_time(cfg, scfg, hw)
    total = pre + step.total_s * scfg.output
    return {
        "prefill_s": pre,
        "decode_step_s": step.total_s,
        "decode_eval_s": step.eval_s,
        "decode_transfer_s": step.transfer_s,
        "decode_compute_s": step.compute_s,
        "total_s": total,
        "tokens_per_s": scfg.output * scfg.batch / max(total - pre, 1e-9),
    }


POLICIES = ("full", "h2o", "h2o_chunked", "prefetch",
            "leoam_lka", "leoam_iakm", "leoam_all")


def compare_policies(cfg: ArchConfig, scfg: ServeCfg,
                     hw: Optional[HWCfg] = None) -> Dict[str, Dict[str, float]]:
    hw = hw or HWCfg()
    return {p: simulate_request(cfg, scfg, hw, p) for p in POLICIES}


def simulate_trace_goodput(cfg: ArchConfig, scfg: ServeCfg, hw: HWCfg,
                           arrivals, policy: str = "leoam_all",
                           servers: int = 1) -> Dict[str, float]:
    """Analytic goodput over an arrival trace (the simulator half of the
    fig15 simulator-vs-measured comparison).

    Replays the trace through a ``servers``-way FCFS queue where each
    request's service time comes from the cost model at ITS OWN prompt
    length (``prefill + max_new * decode_step``); goodput is the fraction
    of arrivals whose sojourn (wait + service) lands within their
    deadline — deadline-free arrivals always count.  ``arrivals`` is any
    iterable with ``t`` / ``prompt_len`` / ``max_new`` / ``deadline_s``
    fields (:class:`repro_torch.serving.trace.Arrival`).  Per-length service
    times are memoized — a zipfian trace repeats lengths heavily."""
    free = [0.0] * max(1, int(servers))
    svc_cache: Dict[int, Dict[str, float]] = {}
    ok = n = 0
    lat_sum = 0.0
    for a in sorted(arrivals, key=lambda a: a.t):
        plen = int(a.prompt_len)
        r = svc_cache.get(plen)
        if r is None:
            r = simulate_request(cfg, replace(scfg, prompt=plen), hw, policy)
            svc_cache[plen] = r
        service = r["prefill_s"] + a.max_new * r["decode_step_s"]
        k = min(range(len(free)), key=free.__getitem__)
        start = max(a.t, free[k])
        free[k] = start + service
        sojourn = free[k] - a.t
        lat_sum += sojourn
        n += 1
        if a.deadline_s is None or sojourn <= a.deadline_s:
            ok += 1
    return {"goodput": ok / max(1, n), "requests": float(n),
            "mean_latency_s": lat_sum / max(1, n),
            "makespan_s": max(free) if n else 0.0}
