"""Threaded, in-order prefetching data loader (a copy of the JAX
package's ``data_utils/loader.py``).

Replaces the reference's multiprocess ``paddle.io.DataLoader`` workers
(reference ``trainer.py:108-111``). Audio decode releases the GIL inside
the native library and numpy, so a thread pool with a bounded prefetch
queue keeps the card fed without process spawns; the waveform DSP runs on
the device in the train step. Batches come out in the sampler's order.

Spans (``utils.tracing``): ``vpr.loader.load``, one batch's reads and
collate on a worker thread, and ``vpr.loader.wait``, the consumer's wait
for it; both carry the batch's index in the epoch as ``id``.
"""

import os
import queue
import threading

from ..utils import tracing

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self, dataset, batch_sampler, collate_fn, num_workers=4,
                 prefetch=4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, int(num_workers))
        self.prefetch = prefetch
        # each worker may drive the C++ batch loader's own thread pool;
        # split the host cores across workers so concurrent batches do
        # not oversubscribe the CPU num_workers-fold
        self._native_threads = max(
            1, (os.cpu_count() or 1) // self.num_workers)

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        batches = list(self.batch_sampler)
        out_q = queue.Queue(maxsize=self.prefetch)
        results = {}
        results_lock = threading.Lock()
        next_emit = [0]
        job_q = queue.Queue()
        for i, b in enumerate(batches):
            job_q.put((i, b))
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i, indices = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    with tracing.span("vpr.loader.load", id=i):
                        # batch-level native fast path (GIL-free C++
                        # thread pool) when the dataset provides one
                        items = (self.dataset.load_batch(
                                     indices, n_threads=self._native_threads)
                                 if hasattr(self.dataset, "load_batch")
                                 else None)
                        if items is None:
                            items = [self.dataset[j] for j in indices]
                        batch = self.collate_fn(items)
                except Exception as e:  # surface worker errors to consumer
                    batch = e
                # emit strictly in order so epochs are deterministic
                with results_lock:
                    results[i] = batch
                    while next_emit[0] in results:
                        out_q.put(results.pop(next_emit[0]))
                        next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with tracing.span("vpr.loader.wait", id=i):
                    item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
