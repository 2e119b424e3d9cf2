"""J05 bad twin: shared mutable state touched off-lock in a threaded
module (J05's findings are L01's now)."""
import threading

import torch


class LaunchStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.by_variant = {}

    def launched(self, variant: str, t: torch.Tensor):
        self.launches += 1  # EXPECT: L01
        self.by_variant[variant] = t.numel()  # EXPECT: L01

    def read(self, variant):
        with self._lock:
            return self.by_variant.get(variant)


class NoLockQueue:
    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)  # EXPECT: L01
