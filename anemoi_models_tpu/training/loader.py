"""Input pipeline: host-side window batching with device double-buffering.

The device's step time should never wait on the host. The pipeline here has the
three standard stages of a JAX input pipeline, each overlapped with the
next:

1. `WindowSampler` — a deterministic, resumable stream of window start
   indices (shuffled per epoch from a seed; `state`/`restore` make it
   checkpointable alongside the train state);
2. `BatchLoader` — a background thread turns index batches into pinned
   numpy arrays ``(batch, window, grid, vars)`` a few batches ahead
   (the reads are memmap/HDF5 slices, so the thread is IO-bound and the
   GIL is released);
3. `device_prefetch` — keeps ``prefetch`` batches resident on device (or
   laid out across a mesh via a `NamedSharding`) so the dispatch of step
   N+1's transfer overlaps step N's compute — the host→device analogue of
   the reference stack's pinned-memory DataLoader workers.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np

__all__ = ["BatchLoader", "WindowSampler", "device_prefetch"]


class WindowSampler:
    """Shuffled epochs of valid window starts.

    A window of ``window`` steps starting at ``t`` needs steps
    ``[t, t + window)``; valid starts are ``0 .. num_steps - window``. Each
    epoch is a seeded permutation, grouped into ``batch_size`` index
    batches (remainder dropped, as every array in the epoch must keep the
    static batch shape under jit).
    """

    def __init__(
        self,
        num_steps: int,
        window: int,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
    ) -> None:
        self.num_valid = num_steps - window + 1
        if self.num_valid < batch_size:
            raise ValueError(
                f"{num_steps} steps give {self.num_valid} windows; need >= {batch_size}"
            )
        self.window = window
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.position = 0  # batches already emitted this epoch

    @property
    def batches_per_epoch(self) -> int:
        return self.num_valid // self.batch_size

    def state(self) -> dict:
        return {"epoch": self.epoch, "position": self.position, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        self.position = int(state["position"])

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.num_valid, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            order = self._epoch_order(self.epoch)
            while self.position < self.batches_per_epoch:
                lo = self.position * self.batch_size
                self.position += 1
                yield order[lo : lo + self.batch_size]
            self.epoch += 1
            self.position = 0


class BatchLoader:
    """Background-thread batch producer over a `DataSource`.

    Iterating yields float32 ``(batch, window, grid, vars)`` arrays. The
    worker stays ``depth`` batches ahead; `close` (or garbage collection)
    stops it. Iteration ends after ``max_batches`` if given, else runs
    for as long as the sampler does.
    """

    def __init__(
        self,
        source,
        sampler: WindowSampler,
        *,
        depth: int = 4,
        max_batches: int | None = None,
        workers: int = 1,
    ) -> None:
        self.source = source
        self.sampler = sampler
        self.max_batches = max_batches
        self._queue: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._pool = None
        if workers > 1:
            # windows within a batch read independent file regions: a small
            # pool overlaps them (numpy/HDF5 reads release the GIL) — at
            # large grids a single batch is GB-scale and read-bound
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self) -> None:
        produced = 0
        try:
            it = iter(self.sampler)
            while True:
                # check the budget BEFORE pulling from the sampler: pulling
                # advances its resumable position, and a checkpoint taken
                # after this loader stops must not record a skipped batch
                if self.max_batches is not None and produced >= self.max_batches:
                    break
                if self._stop.is_set():
                    return
                starts = next(it)
                w = self.sampler.window
                if self._pool is not None:
                    batch = np.stack(
                        list(self._pool.map(lambda t: self.source.window(int(t), w), starts))
                    )
                else:
                    batch = np.stack([self.source.window(int(t), w) for t in starts])
                produced += 1
                while not self._stop.is_set():
                    try:
                        self._queue.put(batch, timeout=0.2)
                        break
                    except queue.Full:
                        continue
            self._queue.put(None)  # end-of-stream marker
        except Exception as e:  # surface worker failures at the consumer
            self._queue.put(e)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        try:  # drain so the worker's blocked put can observe the stop flag
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __del__(self) -> None:
        self._stop.set()


def device_prefetch(
    batches: Iterable[np.ndarray],
    *,
    prefetch: int = 2,
    sharding=None,
) -> Iterator:
    """Keep ``prefetch`` batches in flight on device.

    ``sharding`` may be a `jax.sharding.Sharding` (e.g. batch split over the
    ``data`` mesh axis, grid over ``model``); transfers are dispatched
    asynchronously, so while the caller's train step runs on batch N, batch
    N+1 is already crossing PCIe.
    """
    import jax

    put = (lambda b: jax.device_put(b, sharding)) if sharding is not None else jax.device_put
    buf: collections.deque = collections.deque()
    it = iter(batches)
    while True:
        while len(buf) <= prefetch:
            try:
                buf.append(put(next(it)))
            except StopIteration:
                while buf:
                    yield buf.popleft()
                return
        yield buf.popleft()
