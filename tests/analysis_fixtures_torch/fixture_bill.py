"""Seeded billlint violations (unbilled replica write / promotion)."""

import numpy as np
import torch

DEVICE, HOST, DISK = "device", "host", "disk"


class Log:
    def record(self, src, dst, kind, nbytes):
        pass


class BadBilling:
    def __init__(self):
        self._disk = np.zeros((4, 2, 8))
        self._disk_q = np.zeros((4, 2, 8), np.int8)
        self.log = Log()

    def _record(self, seq, src, dst, kind, nbytes):
        self.log.record(src, dst, kind, nbytes)

    def good_write(self, seq, rows):
        self._disk[seq] = rows.cpu().numpy()
        self._record(seq, HOST, DISK, "kv_replica", rows.nbytes)

    def bad_write(self, seq, rows):
        self._disk[seq] = rows                # SEED: unbilled replica write

    def bad_sidecar_write(self, seq, packed):
        self._disk_q[seq] = packed            # SEED: unbilled sidecar write

    def good_read(self, seq):
        out = torch.from_numpy(np.array(self._disk[seq]))
        self._record(seq, DISK, HOST, "kv", out.nbytes)
        return out

    def bad_read(self, seq):
        return torch.from_numpy(np.array(self._disk[seq]))  # SEED: unbilled

    def bad_kind(self, seq, rows):
        self._disk[seq] = rows
        self._record(seq, HOST, DISK, "mystery_bytes",  # SEED: unknown kind
                     rows.nbytes)
