"""Thread pool with the reference crate's surface.

Copy of the reference's ``utils/thread_pool.py``: ``tests/test_torch_viewer.py``
holds its results equal to the reference's.

Capability parity with the reference ``thread-pool`` crate (reference:
thread-pool/src/lib.rs:80-136): fixed worker count over one shared queue
(work distribution by queue contention, not stealing), ``execute`` for
sync callables, ``execute_async`` for coroutines (each worker drives the
future to completion, lib.rs:55-64), graceful terminate-and-join on close.

Device-side data parallelism replaced this component for compute
(parallel/); this host pool serves the I/O control plane (asset loads,
batched file reads) where Python threads overlap fine.
"""

from __future__ import annotations

import asyncio
import queue
import threading

_TERMINATE = object()


class ThreadPool:
    def __init__(self, size: int):
        if size <= 0:
            raise ValueError("pool size must be positive")
        self.size = size
        self._queue: queue.Queue = queue.Queue()
        self._workers = [
            threading.Thread(target=self._run, name=f"pct-worker-{i}",
                             daemon=True)
            for i in range(size)
        ]
        for w in self._workers:
            w.start()
        self._closed = False

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is _TERMINATE:
                return
            kind, fn = job
            try:
                if kind == "async":
                    asyncio.run(fn)  # pollster-equivalent block_on
                else:
                    fn()
            except Exception:  # workers must survive job failures
                import logging

                logging.getLogger(__name__).exception("pool job failed")

    def execute(self, fn) -> None:
        """Queue a sync callable (lib.rs:96-103)."""
        if self._closed:
            raise RuntimeError("pool is closed")
        self._queue.put(("sync", fn))

    def execute_async(self, coro) -> None:
        """Queue a coroutine; a worker blocks on it (lib.rs:105-120)."""
        if self._closed:
            raise RuntimeError("pool is closed")
        self._queue.put(("async", coro))

    def close(self) -> None:
        """Terminate + join, like the crate's Drop (lib.rs:123-136)."""
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            self._queue.put(_TERMINATE)
        for w in self._workers:
            w.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
