"""Seeded locklint violations for the PyTorch checker.  NOT collected by
pytest (no test_ prefix); test_torch_leolint.py feeds this file to the
analyzer by path and asserts each seeded violation fires."""

import threading

import torch


@torch.compile
def _compiled_helper(x):
    return x * 2


class BadStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._futs_lock = threading.Lock()
        self._futs = []
        self._stream = torch.cuda.Stream()
        self._event = torch.cuda.Event()

    def item_under_lock(self, x):
        with self._lock:
            return x.item()                   # SEED: .item() under lock

    def tolist_under_lock(self, x):
        with self._lock:
            return x.tolist()                 # SEED: .tolist() under lock

    def cpu_under_lock(self, x):
        with self._lock:
            return x.cpu()                    # SEED: .cpu() under lock

    def device_sync_under_lock(self):
        with self._lock:
            torch.cuda.synchronize()          # SEED: device sync under lock

    def stream_sync_under_lock(self):
        with self._lock:
            self._stream.synchronize()        # SEED: stream sync under lock

    def event_sync_under_lock(self):
        with self._lock:
            self._event.synchronize()         # SEED: event sync under lock

    def stream_wait_under_lock(self, other):
        with self._lock:
            self._stream.wait_stream(other)   # SEED: stream wait under lock

    def event_wait_under_lock(self):
        with self._lock:
            self._stream.wait_event(self._event)  # SEED: event wait

    def flush_under_lock(self, mm):
        with self._lock:
            mm.flush()                        # SEED: memmap flush under lock

    def compiled_call_under_lock(self, x):
        with self._lock:
            return _compiled_helper(x)        # SEED: compiled callee

    def ingest_fence(self, seq):
        for f in list(self._futs):
            f.result()

    def fence_under_lock(self):
        with self._lock:
            self.ingest_fence(0)              # SEED: fence under store lock

    def wait_under_lock(self, fut):
        with self._lock:
            return fut.result()               # SEED: future wait under lock

    def indirect_sync(self, x):
        with self._lock:
            return self._helper(x)            # SEED: callee syncs

    def _helper(self, x):
        return x.cpu().numpy()

    def eager_under_lock(self, x):
        with self._lock:
            return torch.stack([x, x])        # fine: only enqueues work

    def bad_order_a(self):
        with self._lock:
            with self._futs_lock:             # edge _lock -> _futs_lock
                pass

    def bad_order_b(self):
        with self._futs_lock:
            with self._lock:                  # SEED: reverse order (cycle)
                pass

    def clean_metadata_update(self, key, val):
        with self._lock:                      # fine: cheap host work only
            self._futs.append((key, val))
