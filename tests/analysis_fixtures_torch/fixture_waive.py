"""Waiver-pragma behavior: a reasoned waiver suppresses; a reason-less
waiver is itself reported."""

import threading


class WaivedStore:
    def __init__(self):
        self._lock = threading.RLock()

    def waived_sync(self, x):
        with self._lock:
            # leolint: waive[locklint] reason=decode thread only touches this path; workers never contend for this fixture lock
            return x.item()

    def badly_waived_sync(self, x):
        with self._lock:
            # leolint: waive[locklint]
            return x.cpu()                    # SEED: waive without reason=
