"""Seeded jitlint violations (impure functions that torch.compile traces)."""

import functools
import threading
import time

import numpy as np
import torch
from torch import compile as tcompile

_lock = threading.Lock()


@torch.compile
def clock_in_compiled(x):
    t = time.perf_counter()                   # SEED: clock in traced fn
    return x * t


@torch.compile(mode="reduce-overhead")
def rng_in_compiled(x):
    noise = np.random.randn(*x.shape)         # SEED: python RNG in traced fn
    return x + torch.from_numpy(noise)


@functools.partial(torch.compile, fullgraph=True)
def lock_in_compiled(x):
    with _lock:                               # SEED: lock inside traced fn
        return x * 2


@tcompile
def wall_clock_in_compiled(x):
    return x * time.time()                    # SEED: clock via an alias


class Stateful:
    def __init__(self):
        self.calls = 0

    def bump(self, x):
        self.calls += 1                       # SEED: attr mutation, reached
        return x + 1                          # from a compiled caller


_state = Stateful()


@torch.compile
def mutation_via_callee(x):
    return _state.bump(x)


def make_step(scale):
    def step(x):
        step.count = 1                        # SEED: factory-pattern root
        return x * scale
    return step


step_fn = torch.compile(make_step(2.0))

pure_fn = torch.compile(lambda x: torch.tanh(x))   # fine: pure lambda root


def not_compiled(x):
    return x * time.time()                    # fine: runs eagerly
