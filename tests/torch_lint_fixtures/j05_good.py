"""J05 good twin: every shared mutation lock-held or on an
intrinsically thread-safe container -- zero findings."""
import queue
import threading

import torch


class LaunchStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.by_variant = {}

    def launched(self, variant: str, t: torch.Tensor):
        with self._lock:
            self.launches += 1
            self.by_variant[variant] = t.numel()

    def read(self, variant):
        with self._lock:
            return self.by_variant.get(variant)


class SafeQueue:
    def __init__(self):
        self.items = queue.Queue()  # Queue serialises internally

    def put(self, item):
        self.items.put(item)
