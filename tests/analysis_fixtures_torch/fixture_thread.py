"""Seeded threadlint violations (wrong-thread pool mutation)."""

from concurrent.futures import ThreadPoolExecutor

from repro_torch.serving.sanitizer import decode_thread_only, worker_thread


class Pool:
    @decode_thread_only
    def scatter(self, slots, kv):
        self.kv[slots] = kv

    def lookup(self, key):
        return None


class Store:
    def __init__(self):
        self.pool = Pool()
        self._exec = ThreadPoolExecutor(1)

    @worker_thread
    def ingest_worker(self, kv):
        self.pool.scatter([0], kv)            # SEED: worker -> decode-only

    @worker_thread
    def indirect_worker(self, kv):
        self._place(kv)                       # SEED: reaches scatter via helper

    def _place(self, kv):
        self.pool.scatter([1], kv)

    def kick(self, kv):
        self._exec.submit(self._submitted, kv)

    def _submitted(self, kv):                 # entry via .submit(...)
        self.pool.scatter([2], kv)            # SEED: submitted work -> decode-only

    @worker_thread
    def clean_worker(self, kv):
        return self.pool.lookup((0, 0))       # fine: any-thread read
