"""Host-to-device staging beside compute (counterpart of
slowfast_tpu/parallel/prefetch.py; reference tools/train_net.py:79-98, the
pinned-memory ``non_blocking`` copies behind DataLoader workers).

``DevicePrefetcher`` runs ``stage_fn`` on the items of a host iterator on a
background thread, at most ``depth`` items ahead of the consumer, and
yields the staged items in order. Exceptions from the iterator or from
staging reach the consumer; a consumer that stops early (a ``break``, an
exception) releases the thread and drops the staged items.

On the card the staging thread runs on a side ``torch.cuda.Stream``: the
copies that ``to_device`` makes there (from pinned memory, non-blocking)
overlap the step on the compute stream. After staging an item the thread
records an event; the consumer makes its current stream wait on it and
calls ``record_stream`` on every tensor of the item, so the caching
allocator does not hand their memory out again before the consumer's
stream is done with them.

``staged_inline`` has the same interface and stages on the caller's thread
and stream, one item at a time: the synchronous yardstick.
"""

import contextlib
import queue
import threading

import numpy as np
import torch


def to_device(x, device):
    """``x`` (a numpy array or a CPU tensor) on ``device``: through pinned
    memory with a non-blocking copy on the current stream for a CUDA
    device."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def tensors(item):
    """The tensors of a nested structure of lists, tuples and dicts."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from tensors(v)


def staged_inline(host_iter, stage_fn, depth=1, device=None):
    """``stage_fn`` of each item on the calling thread and its current
    stream: no overlap (``depth`` and ``device`` are not used)."""
    for item in host_iter:
        yield stage_fn(item)


class DevicePrefetcher:
    """Iterate ``stage_fn(item)`` for the items of ``host_iter``, staged on a
    background thread at most ``depth`` items ahead; on a CUDA ``device``,
    on a side stream."""

    def __init__(self, host_iter, stage_fn, depth=2, device=None):
        self._iter = host_iter
        self._stage = stage_fn
        self._depth = max(int(depth), 1)
        self._device = torch.device(device) if device is not None else None

    def __iter__(self):
        cuda = self._device is not None and self._device.type == "cuda"
        side = torch.cuda.Stream(self._device) if cuda else None
        q = queue.Queue()
        slots = threading.Semaphore(self._depth)
        stop = object()
        closed = threading.Event()

        def slot():
            """A free place ahead of the consumer; False once it is gone."""
            while not closed.is_set():
                if slots.acquire(timeout=0.1):
                    return True
            return False

        def run():
            try:
                with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                    it = iter(self._iter)
                    while slot():
                        try:
                            item = next(it)
                        except StopIteration:
                            break
                        out = self._stage(item)
                        event = None
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(side)
                        q.put((out, event))
            except BaseException as e:  # noqa: BLE001 -- raised by the consumer
                q.put(e)
            finally:
                q.put(stop)

        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        try:
            while True:
                got = q.get()
                if got is stop:
                    break
                if isinstance(got, BaseException):
                    raise got
                slots.release()
                out, event = got
                if event is not None:
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(event)
                    for t in tensors(out):
                        if t.device.type == "cuda":
                            t.record_stream(stream)
                yield out
        finally:
            closed.set()
            # Drop the staged items so their device memory is freed now.
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=5.0)
