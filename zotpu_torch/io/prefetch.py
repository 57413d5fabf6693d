"""Background-thread batch prefetcher for the host input pipeline.

A copy of zotpu/io/prefetch.py.

The parse stages (gzip inflate via zlib, numpy LUT encode, the ctypes native
parser) all release the GIL, so a single prefetch thread genuinely overlaps
host parsing with device compute and host-side merging (SURVEY.md section 2b
"PP analog": input pipeline software pipelining). ``prefetch_many`` runs a
pool of such threads over files, or over the record-aligned pieces of one
plain FASTQ file (workloads/kmerize._iter_batches says when a file is cut).
The driving thread's wait for the next item is the span ``parse_wait``
(metrics.span).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator, TypeVar

from zotpu_torch import metrics

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2,
             span: str | None = "parse_wait") -> Iterator[T]:
    """Run ``it`` in a daemon thread, buffering up to ``depth`` items.

    The worker shuts down promptly if the consumer abandons the generator
    (exception or early close): puts are polled against a stop event so the
    thread never blocks forever holding parsed batches. The consumer's wait
    for an item is the span ``span`` (None: no span, for a consumer that is
    not the thread driving the job).
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
            with (metrics.span(span) if span else contextlib.nullcontext()):
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

    This is the parallel half of the host input pipeline (SURVEY.md
    section 7 "gzip inflation parallelized across files"): zlib inflate,
    numpy encode, and the native parser all release the GIL, so W workers
    genuinely parse W sources at once. A source is a file, or a piece of a
    plain FASTQ file (``io/fastq.cut_fastq``). ``factories`` is then a lazy
    iterable: one thread of its own advances it (the cutter, which reads
    the file in order), up to ``workers`` factories ahead of the workers,
    and it stops when the workers end. A worker's error reaches the
    consumer at once; closing this generator stops every thread.
    """
    source = None
    if isinstance(factories, (list, tuple)):
        if not factories:
            return
        workers = min(workers, len(factories))
    else:
        factories = source = prefetch(factories, depth=workers, span=None)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    errs: list[BaseException] = []
    pending = enumerate(factories)
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
            try:
                with lock:
                    nxt = next(pending, None)
                if nxt is None:
                    return
                idx, fac = nxt
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
               for _ in range(workers)]
    for t in threads:
        t.start()

    def closer():
        for t in threads:
            t.join()
        if source is not None:
            source.close()
        _put(_SENTINEL)

    threading.Thread(target=closer, daemon=True).start()
    try:
        while True:
            with metrics.span("parse_wait"):
                item = q.get()
            if item is _SENTINEL:
                break
            yield item
    finally:
        stop.set()
    if errs:
        raise errs[0]
