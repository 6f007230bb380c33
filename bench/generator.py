"""The one traffic generator: reads a mix's parameters from
``bench/traffic/<mix>.json`` and turns them, with the run's seed, into the
requests a cell serves.

Two kinds of mix:

* ``closed``: ``sessions`` sessions admitted in set-up, each decoding in
  every round of the window.  Their context lengths are a fixed set spread
  evenly over ``[prompt_min, prompt_max]``; the seed orders them and draws
  the tokens.
* ``open``: Poisson (or MMPP) arrivals at a fixed rate.  The arrival gaps
  and prompt lengths come from :func:`gen_trace` (a copy of
  ``repro_torch.serving.trace.gen_trace``, with a ``band`` scenario: the
  whole ``[min_prompt, max_prompt]`` range) under the mix's fixed
  ``base_seed``, so every run offers the same schedule of due times and
  lengths (the same work; a seed that reordered them would change how
  long requests queue behind long prompts, and the spread of the tails
  with it); the run's seed draws the tokens.

Token ids are uniform over the vocabulary.  Nothing here reads the
program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> Dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


# ---------------------------------------------------------------------------
# gen_trace, copied (seeded MMPP arrivals, zipf-tailed lengths)
# ---------------------------------------------------------------------------

_SCENARIOS = ("chat", "rag", "longdoc", "mixed", "band")
_ZIPF_RANK_CAP = 64


@dataclass(frozen=True)
class Arrival:
    t: float
    prompt_len: int
    max_new: int


@dataclass
class TraceCfg:
    n_requests: int = 64
    base_rate: float = 4.0
    burst_rate: float = 32.0
    calm_dwell_s: float = 2.0
    burst_dwell_s: float = 0.5
    zipf_a: float = 1.4
    min_prompt: int = 32
    max_prompt: int = 512
    max_new: int = 16
    scenario: str = "mixed"

    def __post_init__(self) -> None:
        if self.scenario not in _SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}")
        if not self.zipf_a > 1.0:
            raise ValueError(f"zipf_a={self.zipf_a} must be > 1")
        if self.min_prompt < 1 or self.max_prompt < self.min_prompt:
            raise ValueError("need 1 <= min_prompt <= max_prompt")


def _length_band(cfg: TraceCfg, scenario: str) -> Tuple[int, int]:
    lo, hi = cfg.min_prompt, cfg.max_prompt
    if scenario == "band":
        return lo, hi
    if scenario == "chat":
        return lo, max(lo, hi // 4)
    if scenario == "rag":
        return max(lo, hi // 4), max(lo, hi // 2)
    return max(lo, hi // 2), hi


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
    return int(round(lo * (hi / lo) ** frac))


def gen_trace(cfg: TraceCfg, seed: int = 0) -> List[Arrival]:
    """Deterministic MMPP arrival trace (equal rates: Poisson)."""
    rng = np.random.RandomState(int(seed) & 0x7FFFFFFF)
    out: List[Arrival] = []
    t = 0.0
    burst = False
    t_switch = rng.exponential(cfg.calm_dwell_s)
    while len(out) < cfg.n_requests:
        rate = cfg.burst_rate if burst else cfg.base_rate
        dt = rng.exponential(1.0 / max(rate, 1e-9))
        if t + dt >= t_switch:
            t = t_switch
            burst = not burst
            t_switch = t + rng.exponential(
                cfg.burst_dwell_s if burst else cfg.calm_dwell_s)
            continue
        t += dt
        out.append(Arrival(t=t, prompt_len=_prompt_len(cfg, rng),
                           max_new=cfg.max_new))
    return out


# ---------------------------------------------------------------------------
# What a run serves
# ---------------------------------------------------------------------------


@dataclass
class Planned:
    """One request of a run: when it is due (seconds after the open loop
    starts; 0 for a closed session), its prompt and its decode budget."""
    due: float
    prompt: np.ndarray
    max_new: int


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=n, dtype=np.int64)


def closed_sessions(mix: Dict, seed: int, vocab: int, max_len: int
                    ) -> List[Planned]:
    """The closed loop's sessions: a fixed set of context lengths in the
    seed's order, each with room to decode until ``max_len``."""
    n = int(mix["sessions"])
    lens = np.linspace(mix["prompt_min"], mix["prompt_max"], n)
    lens = [int(round(x)) for x in lens]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    room = int(mix["room"])
    out = []
    for i in order:
        L = lens[i]
        if L + room > max_len:
            raise ValueError(f"a {L}-token context leaves less than "
                             f"{room} tokens of room to max_len {max_len}")
        out.append(Planned(0.0, _tokens(rng, L, vocab), max_len - 1 - L))
    return out


def open_arrivals(mix: Dict, seed: int, vocab: int,
                  rate: Optional[float] = None) -> List[Planned]:
    """The open loop's arrivals: ``gen_trace`` under the mix's fixed
    ``base_seed`` at the mix's rate (``rate`` overrides it: the knee
    sweep).  Every seed offers the same schedule of due times and prompt
    lengths -- the same work -- and draws its own tokens."""
    rate = float(mix["rate"] if rate is None else rate)
    tc = TraceCfg(n_requests=int(mix["n_requests"]), base_rate=rate,
                  burst_rate=float(mix.get("burst_factor", 1.0)) * rate,
                  zipf_a=float(mix["zipf_a"]),
                  min_prompt=int(mix["prompt_min"]),
                  max_prompt=int(mix["prompt_max"]),
                  max_new=int(mix["max_new"]),
                  scenario=mix.get("scenario", "band"))
    rng = np.random.default_rng(seed)
    return [Planned(a.t, _tokens(rng, a.prompt_len, vocab), a.max_new)
            for a in gen_trace(tc, int(mix["base_seed"]))]
