"""leolint for the PyTorch engine — the repo's static checker for the
tiered serving engine, with PyTorch's host-device sync points.

Four passes over the AST + call graph (stdlib ``ast`` only):

========== ==============================================================
locklint   no host-device sync (``.item()``, ``.tolist()``, ``.cpu()``,
           ``synchronize``, stream/event waits) / memmap flush / compiled
           call / fence / future wait while the store lock may be held;
           lock acquisition order acyclic
threadlint executor-submitted work never reaches ``@decode_thread_only``
           code
billlint   replica/sidecar writes and disk→host promotions pair with a
           billing call from the transfer↔bill table, in-function
jitlint    no clocks, Python RNG, locks, or Python-state mutation inside
           (or reachable from) ``torch.compile``-traced functions
========== ==============================================================

Run as ``python -m repro_torch.analysis [--strict] [paths...]`` (default
``src/repro_torch``); findings are
suppressible only via ``# leolint: waive[pass] reason=...`` pragmas (see
``docs/INVARIANTS.md``).
"""

from repro_torch.analysis.core import (Finding, Index,  # noqa: F401
                                       PASS_IDS, run_passes)
