# A copy of rlaifv_tpu/utils/prefetch.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Background host-side batch prefetcher (the reference uses 16 torch
DataLoader workers, script/train/llava15_train.sh:44; here a thread pool
keeps N collated batches ahead of the device)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator


def prefetch_iterator(make_batch: Iterator, depth: int = 2) -> Iterator:
    """Wrap an iterator; pull `depth` items ahead on a worker thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in make_batch:
                q.put(item)
        except BaseException as e:  # surface worker errors to the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item
