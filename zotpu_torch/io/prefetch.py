"""Background-thread batch prefetcher for the host input pipeline.

A copy of zotpu/io/prefetch.py.

The parse stages (gzip inflate via zlib, numpy LUT encode, the ctypes native
parser) all release the GIL, so a single prefetch thread genuinely overlaps
host parsing with device compute and host-side merging (SURVEY.md section 2b
"PP analog": input pipeline software pipelining).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items.

    The worker shuts down promptly if the consumer abandons the generator
    (exception or early close): puts are polled against a stop event so the
    thread never blocks forever holding parsed batches.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
        t.join(timeout=5)
    if err:
        raise err[0]


def prefetch_many(factories, workers: int = 4, depth: int = 8):
    """Run up to ``workers`` generators concurrently, one thread each (the
    next factory starts as a worker frees up), buffering items in ONE
    bounded shared queue (flat RSS). Yields ``(factory_index, item)`` in
    arrival order -- consumers that need per-source continuity key their
    state by the index.

    This is the multi-file half of the parallel host input pipeline
    (SURVEY.md section 7 "gzip inflation parallelized across files"): zlib
    inflate, numpy encode, and the native parser all release the GIL, so
    W workers genuinely decompress W files at once.
    """
    factories = list(factories)
    if not factories:
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    errs: list[BaseException] = []
    pending = list(enumerate(factories))
    lock = threading.Lock()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        while not stop.is_set():
            with lock:
                if not pending:
                    return
                idx, fac = pending.pop(0)
            try:
                for item in fac():
                    if not _put((idx, item)):
                        return
            except BaseException as e:  # re-raised in the consumer
                errs.append(e)
                # fail FAST: wake the consumer now instead of after every
                # other worker drains (a corrupt first
                # .gz used to surface only after the whole run parsed)
                _put(_SENTINEL)
                return

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(min(workers, len(factories)))]
    for t in threads:
        t.start()

    def closer():
        for t in threads:
            t.join()
        _put(_SENTINEL)

    threading.Thread(target=closer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
    if errs:
        raise errs[0]
