"""Background-thread data prefetching (a copy of the JAX package's
``data/prefetch.py``): a small thread pool prepares upcoming collated
batches while the device runs the current step; batches come out in the
order of ``indices`` whatever order the threads finish in.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator


class Prefetcher:
    """Wrap an index-able dataset + collate into a prefetching iterator."""

    def __init__(self, fetch: Callable[[int], object], indices: Iterable[int],
                 num_threads: int = 2, buffer: int = 4):
        self.fetch = fetch
        self.indices = list(indices)
        self.buffer = max(buffer, 1)
        self.num_threads = max(min(num_threads, len(self.indices)), 1)

    def __len__(self) -> int:
        return len(self.indices)

    def __iter__(self) -> Iterator:
        idx_q: "queue.Queue" = queue.Queue()
        for pos, i in enumerate(self.indices):
            idx_q.put((pos, i))

        results: dict[int, object] = {}
        cond = threading.Condition()  # wakes the consumer on each result
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    pos, i = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.fetch(i)
                except Exception as e:  # surface errors to the consumer
                    item = e
                with cond:
                    results[pos] = item
                    cond.notify_all()
                    # bound readahead: don't run more than `buffer` items
                    # ahead of the consumer (results holds the backlog)
                    while len(results) > self.buffer and not stop.is_set():
                        cond.wait(0.1)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()

        try:
            for pos in range(len(self.indices)):
                with cond:
                    while pos not in results:
                        cond.wait()
                    item = results.pop(pos)
                    cond.notify_all()  # unblock producers waiting on backlog
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            with cond:
                cond.notify_all()


def prefetch_batches(dataset, batch_size: int, collate: Callable,
                     order, num_threads: int = 2, drop_last: bool = True):
    """Prefetching equivalent of train.loop._batches.

    ``drop_last=True`` (training default): only full batches are yielded.
    ``drop_last=False`` (evaluation): a final shorter batch carries the
    remainder, so every dataset item is seen exactly once per epoch.
    """
    order = list(order)
    starts = list(range(0, max(len(order) - batch_size + 1, 0), batch_size))
    if not drop_last:
        done = len(starts) * batch_size
        if done < len(order):
            starts.append(done)  # final partial batch

    def fetch(s):
        return collate([dataset[int(i)] for i in order[s:s + batch_size]])

    return Prefetcher(fetch, starts, num_threads=num_threads)
