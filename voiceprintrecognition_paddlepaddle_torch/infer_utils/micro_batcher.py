"""Dynamic micro-batching for the serving embed path (copy of the JAX
package's ``infer_utils/micro_batcher.py``).

Embedding throughput comes from batching: a batch-1 launch leaves most of
the card idle. ``MicroBatcher`` aggregates concurrent requests inside a
short window into ONE ``Predictor.predict_batch`` call, made from its own
thread, so the kernels launch from that thread.

Requests of mixed durations are safe: ``predict_batch`` buckets the
window's clips to a padded length and masks the padding on the device.
"""

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..utils import tracing

__all__ = ["MicroBatcher"]


class MicroBatcher:
    """Aggregate concurrent embed requests into single device batches.

    ``embed(samples)`` blocks until the surrounding batch completes and
    returns the clip's embedding; ``embed_async`` returns a Future (use
    for request handlers that need several embeddings, e.g. contrast —
    submit both, then wait, so they ride the same batch).

    ``window_ms`` is the maximum extra latency a request pays waiting
    for companions; ``max_batch`` caps device batch size. Counters
    ``batches``/``items`` expose the achieved aggregation. An exception
    raised by ``predict_batch`` reaches every waiter of that batch.

    Spans (``utils.tracing``), all with the batch's sequence number as
    ``id``: ``vpr.batcher.wait``, each request's wait from its enqueue to
    the start of its batch, and ``vpr.batcher.batch``, the batch's
    ``predict_batch`` call.
    """

    def __init__(self, predictor, window_ms=5.0, max_batch=64):
        if not (window_ms > 0 and max_batch >= 1):
            raise ValueError("window_ms must be > 0 and max_batch >= 1")
        self.predictor = predictor
        self.window = window_ms / 1000.0
        self.max_batch = int(max_batch)
        self.batches = 0
        self.items = 0
        self._seq = itertools.count()       # the ``id`` of each batch's spans
        self._q = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def embed_async(self, samples):
        fut = Future()
        self._q.put((np.asarray(samples, np.float32), fut, time.time_ns()))
        return fut

    def embed(self, samples):
        return self.embed_async(samples).result()

    # ------------------------------------------------------------------
    def _run(self):
        while True:
            batch = [self._q.get()]  # block for the first request
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=timeout))
                except queue.Empty:
                    break
            seq = next(self._seq)
            start = time.time_ns()
            for _, _, queued in batch:
                tracing.add("vpr.batcher.wait", queued, start, id=seq)
            try:
                # batch_size must cover the aggregated window, else
                # predict_batch's default (32) re-splits the device batch
                with tracing.span("vpr.batcher.batch", id=seq):
                    embs = self.predictor.predict_batch(
                        [s for s, _, _ in batch], batch_size=self.max_batch)
            except Exception as e:  # propagate to every waiter
                for _, fut, _ in batch:
                    fut.set_exception(e)
                continue
            self.batches += 1
            self.items += len(batch)
            for (_, fut, _), emb in zip(batch, embs):
                fut.set_result(np.asarray(emb))
