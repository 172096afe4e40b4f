"""Host-side data pipeline: RAM caching, threaded device prefetch, and
parallel batch decode.

Port of ``curvature_tpu/data/prefetch.py`` in CUDA terms (the reference's
``pin_memory`` + ``non_blocking`` copies, datasets.py:104-106,
factors.py:51). :class:`DevicePrefetcher` runs a background thread that
stages the next ``depth`` batches: each one copied into pinned host
memory, then to the card by ``non_blocking`` copies on a side
``torch.cuda.Stream``, with an event recorded after them; the consumer's
stream waits on that event before the batch is handed out, so a batch is
never read before its copy has landed, and the copy overlaps the
consumer's compute. A loader error mid-epoch is raised in the consumer,
never taken for the end of the epoch.
"""
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from curvature_tpu_torch.utils.device import resolve_device


class CachedLoader:
    """Materializes any (x, y) batch iterable into RAM once, then serves
    from memory (the reference's Memory.set_use_cache flow,
    datasets.py:108-127)."""

    def __init__(self, loader: Iterable):
        self._loader = loader
        self._cache = None

    def _fill(self):
        self._cache = [(np.asarray(x), np.asarray(y))
                       for x, y in self._loader]

    def __len__(self):
        if self._cache is None:
            self._fill()
        return len(self._cache)

    def __iter__(self):
        if self._cache is None:
            self._fill()
        return iter(self._cache)


class DevicePrefetcher:
    """Wraps an (x, y) batch iterable of numpy arrays; yields them as
    tensors on ``device`` (CUDA unless ``"cpu"`` is passed), ``depth``
    batches staged ahead by a background thread (JAX prefetch.py:45-98).
    On the CPU a batch is only wrapped as a tensor."""

    def __init__(self, loader: Iterable, depth: int = 2, device=None):
        self.loader = loader
        self.depth = depth
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.loader)

    def _stage(self, arrays, stream):
        """(tensors on the device, the event the consumer waits on)."""
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        if stream is None:
            return host, None
        with torch.cuda.stream(stream):
            out = [h.pin_memory().to(self.device, non_blocking=True)
                   for h in host]
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        sentinel = object()
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def producer():
            # a loader failure must reach the consumer, not end the epoch
            # early: factors would be estimated from a truncated dataset
            # with exit code 0
            try:
                for batch in self.loader:
                    q.put(self._stage(batch, stream))
                q.put(sentinel)
            except BaseException as e:       # re-raised by the consumer
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            tensors, event = item
            if event is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(event)
                for t in tensors:
                    # made on the side stream, used on this one: the
                    # allocator must not reuse it before this stream is done
                    t.record_stream(current)
            yield tuple(tensors)
        thread.join()


class ParallelDecodeLoader:
    """Decodes batches of an inner loader with ``batch_indices()`` and a
    thread-safe ``load_batch(sel)`` (the image-folder loaders) by a thread
    pool, ``lookahead`` batches ahead of consumption: the analogue of
    DataLoader workers over the serialized sample list
    (imagenet.py:88-140)."""

    def __init__(self, folder_loader, workers: int = 4, lookahead: int = 4):
        self.inner = folder_loader
        self.workers = workers
        self.lookahead = lookahead

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        load = self.inner.load_batch
        batches = list(self.inner.batch_indices())
        with ThreadPoolExecutor(self.workers) as pool:
            futures = [pool.submit(load, sel)
                       for sel in batches[:self.lookahead]]
            for i in range(len(batches)):
                x, y = futures[i].result()
                if i + self.lookahead < len(batches):
                    futures.append(pool.submit(
                        load, batches[i + self.lookahead]))
                yield x, y
