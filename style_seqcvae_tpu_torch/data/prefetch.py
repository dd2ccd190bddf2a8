"""Host-side batch prefetching (copy of ``style_seqcvae_tpu/data/prefetch.py:1-39``).

A background thread runs a Python batch generator ahead of its consumer,
and a small queue decouples host collation from the device's work."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


def prefetch(iterable: Iterable, buffer_size: int = 4) -> Iterator:
    """Wrap any (possibly infinite) batch iterator with a background
    producer thread. Exceptions in the producer re-raise in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _SENTINEL = object()

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item
