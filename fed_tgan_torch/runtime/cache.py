"""A per-process cache whose every entry is built once.

``functools.lru_cache`` does not hold a lock while it computes: two
threads that miss one key at the same moment both build it (two serving
workers' first launches, for example, each copied the layout's tables to
the card and each ran its own ``nvcc``).  :func:`built_once` serialises
the calls through a lock, so the first caller builds and the others find
the entry.  Stdlib only.
"""

from __future__ import annotations

import functools
import threading

__all__ = ["built_once"]


def built_once(maxsize=None):
    """``functools.lru_cache(maxsize)`` whose misses build under a lock;
    ``cache_clear`` and ``cache_info`` as lru_cache's."""
    def decorate(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)
        lock = threading.Lock()

        @functools.wraps(fn)
        def call(*args):
            with lock:
                return cached(*args)

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call
    return decorate
