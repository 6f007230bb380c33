"""Seeded bursty arrival traces shared by the analytic simulator and the
measured load harness.

Public serving traffic is neither Poisson-smooth nor length-uniform: load
arrives in bursts (an MMPP — Markov-modulated Poisson process — with a
calm and a burst state captures the on/off character real traces show)
and prompt lengths are heavy-tailed (most requests are short chat turns,
a zipfian tail stretches to RAG contexts and whole-document prompts).
This module generates such traces deterministically from one integer
seed, so an analytic simulator (the JAX package's ``serving/simulator.py``,
not ported yet: ROADMAP A14) and the measured
:class:`~repro_torch.serving.overload.LoadHarness` replay the *same*
arrival sequence and compare like with like.

Scenarios shape the prompt-length mix:

=============  =========================================================
``chat``       short turns: zipfian lengths over the bottom quarter of
               the configured range
``rag``        retrieval contexts: the middle of the range
``longdoc``    whole-document prompts: the top half of the range
``mixed``      60% chat / 30% rag / 10% longdoc per arrival — the
               public-traffic blend the overload bench replays
=============  =========================================================
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Arrival", "TraceCfg", "gen_trace"]

_SCENARIOS = ("chat", "rag", "longdoc", "mixed")

#: zipf ranks are capped here and mapped geometrically onto the
#: scenario's length band — rank 1 (the common case) lands at the short
#: end, the capped tail at the long end
_ZIPF_RANK_CAP = 64


@dataclass(frozen=True)
class Arrival:
    """One request of a trace: arrival time (seconds from trace start),
    prompt length and decode budget in tokens, scheduling class, and an
    optional per-request latency deadline."""

    t: float
    prompt_len: int
    max_new: int
    priority: int = 0
    deadline_s: Optional[float] = None


@dataclass
class TraceCfg:
    n_requests: int = 64
    base_rate: float = 4.0         # req/s in the calm MMPP state
    burst_rate: float = 32.0       # req/s in the burst state
    calm_dwell_s: float = 2.0      # mean dwell per calm episode
    burst_dwell_s: float = 0.5     # mean dwell per burst episode
    zipf_a: float = 1.4            # prompt-length tail exponent (>1;
                                   # smaller = heavier tail)
    min_prompt: int = 32
    max_prompt: int = 512
    max_new: int = 16
    scenario: str = "mixed"        # chat | rag | longdoc | mixed
    deadline_s: Optional[float] = None
    priorities: Tuple[int, ...] = (0,)
                                   # scheduling classes drawn uniformly
                                   # per arrival (e.g. (0, 0, 0, 1) for a
                                   # 25% high-priority slice)

    def __post_init__(self) -> None:
        if self.scenario not in _SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r} "
                             f"(one of {_SCENARIOS})")
        if not (self.zipf_a > 1.0):
            raise ValueError(
                f"zipf_a={self.zipf_a} must be > 1 (numpy's zipf sampler "
                f"requires it; 1.2–2.0 spans realistic tails)")
        if self.min_prompt < 1 or self.max_prompt < self.min_prompt:
            raise ValueError(
                f"need 1 <= min_prompt <= max_prompt, got "
                f"[{self.min_prompt}, {self.max_prompt}]")


def _length_band(cfg: TraceCfg, scenario: str) -> Tuple[int, int]:
    lo, hi = cfg.min_prompt, cfg.max_prompt
    if scenario == "chat":
        return lo, max(lo, hi // 4)
    if scenario == "rag":
        return max(lo, hi // 4), max(lo, hi // 2)
    return max(lo, hi // 2), hi        # longdoc


def _prompt_len(cfg: TraceCfg, rng: np.random.RandomState) -> int:
    scenario = cfg.scenario
    if scenario == "mixed":
        scenario = ("chat", "rag", "longdoc")[
            int(rng.choice(3, p=[0.6, 0.3, 0.1]))]
    lo, hi = _length_band(cfg, scenario)
    if hi <= lo:
        return lo
    rank = min(int(rng.zipf(cfg.zipf_a)), _ZIPF_RANK_CAP)
    frac = (rank - 1) / (_ZIPF_RANK_CAP - 1)
    # geometric interpolation keeps the tail heavy in LENGTH, not just
    # in rank: rank 1 -> lo, the capped tail -> hi
    return int(round(lo * (hi / lo) ** frac))


def gen_trace(cfg: TraceCfg, seed: int = 0) -> List[Arrival]:
    """Deterministic MMPP arrival trace: exponential state dwells switch
    between the calm and burst Poisson rates; each arrival draws a
    zipfian prompt length from its scenario band and a uniform priority
    class.  Two calls with the same (cfg, seed) return identical traces
    (the contract the simulator-vs-measured comparison relies on)."""
    rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    out: List[Arrival] = []
    t = 0.0
    burst = False
    t_switch = rng.exponential(cfg.calm_dwell_s)
    while len(out) < cfg.n_requests:
        rate = cfg.burst_rate if burst else cfg.base_rate
        dt = rng.exponential(1.0 / max(rate, 1e-9))
        if t + dt >= t_switch:
            # state flip BEFORE the next arrival would land: re-draw the
            # interarrival under the new rate from the switch instant
            t = t_switch
            burst = not burst
            t_switch = t + rng.exponential(
                cfg.burst_dwell_s if burst else cfg.calm_dwell_s)
            continue
        t += dt
        out.append(Arrival(
            t=t,
            prompt_len=_prompt_len(cfg, rng),
            max_new=cfg.max_new,
            priority=int(cfg.priorities[
                int(rng.randint(len(cfg.priorities)))]),
            deadline_s=cfg.deadline_s))
    return out
