"""Paired DICOM dataset, the shuffled training loader with threaded decode,
the sequential evaluation loader and the device prefetcher (counterpart of
``mtd_gan_tpu/data/pipeline.py``). Slices decode through the native codec
(``data/native.py``) and through the Python one (``data/dicom.py``) only
where the native one is missing or refuses a file. Loader batches are host
numpy arrays; :class:`prefetch_to_device` moves them to the device ahead of
the consumer, which runs the preprocess there.

Layout convention of the Mayo LDCT release:
  <root>/<split>/*/n_20/*.(IMA|dcm)   quarter-dose inputs
  <root>/<split>/*/n_100/*.(IMA|dcm)  full-dose targets
sorted naturally and paired positionally.
"""

from __future__ import annotations

import collections
import glob
import itertools
import os
import queue
import re
import threading
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from mtd_gan_tpu_torch.data import native
from mtd_gan_tpu_torch.data.dicom import get_pixels_hu


def natural_sort(paths: Sequence[str]) -> List[str]:
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"([0-9]+)", s)]

    return sorted(paths, key=key)


class PairedDicomDataset:
    """Positionally paired (n_20, n_100) DICOM slices. ``decoded`` counts the
    files each codec decoded (``"native"``, ``"python"``)."""

    def __init__(self, root: str, split: str = "train",
                 low_key: str = "n_20", high_key: str = "n_100",
                 extensions: Tuple[str, ...] = ("IMA", "dcm")):
        self.root, self.split = root, split
        lows: List[str] = []
        highs: List[str] = []
        for ext in extensions:
            lows += glob.glob(os.path.join(root, split, "**", low_key, f"*.{ext}"),
                              recursive=True)
            highs += glob.glob(os.path.join(root, split, "**", high_key, f"*.{ext}"),
                               recursive=True)
        self.low_paths = natural_sort(lows)
        self.high_paths = natural_sort(highs)
        if len(self.low_paths) != len(self.high_paths):
            raise ValueError(
                f"unpaired dataset: {len(self.low_paths)} low vs "
                f"{len(self.high_paths)} high dose slices under {root}/{split}")
        self.decoded = {"native": 0, "python": 0}
        self._count_lock = threading.Lock()  # the loader decodes on threads

    def __len__(self) -> int:
        return len(self.low_paths)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._decode(self.low_paths[idx]), self._decode(self.high_paths[idx])

    def _decode(self, path: str) -> np.ndarray:
        hu = native.decode_hu(path)
        codec = "native" if hu is not None else "python"
        with self._count_lock:
            self.decoded[codec] += 1
        return hu if hu is not None else get_pixels_hu(path)


def batched_indices(n: int, batch_size: int, shuffle: bool, drop_last: bool,
                    seed: int) -> List[np.ndarray]:
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    batches = [idx[i:i + batch_size] for i in range(0, n, batch_size)]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    return batches


def load_batch(ds: PairedDicomDataset, idxs) -> Tuple[np.ndarray, np.ndarray]:
    """int16 HU ``(B, H, W, 1)`` pair."""
    pairs = [ds.load(int(i)) for i in idxs]
    return (np.stack([p[0] for p in pairs])[..., None],
            np.stack([p[1] for p in pairs])[..., None])


class TrainLoader:
    """Shuffled, drop-last batches (reference dataloaders.py:5-16) of
    ``(hu_x, hu_y)``, decoded by ``num_threads`` threads at most ``prefetch``
    batches ahead, in the shuffled order. ``len()`` is the number of
    batches."""

    def __init__(self, ds: PairedDicomDataset, batch_size: int, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 2):
        self.ds = ds
        self.batches = batched_indices(len(ds), batch_size, True, True, seed)
        self.num_threads, self.prefetch = max(1, num_threads), max(1, prefetch)

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        slots = [queue.Queue(maxsize=1) for _ in self.batches]
        ahead = threading.Semaphore(self.prefetch + self.num_threads)
        next_idx = iter(range(len(self.batches)))
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                ahead.acquire()
                with lock:
                    i = next(next_idx, None)
                if i is None:
                    return
                try:
                    slots[i].put(("ok", load_batch(self.ds, self.batches[i])))
                except Exception as e:  # surfaced in the consumer's thread
                    slots[i].put(("err", e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_threads, len(self.batches)))]
        for t in threads:
            t.start()
        try:
            for slot in slots:
                kind, item = slot.get()
                ahead.release()
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()
            for _ in threads:
                ahead.release()
            for t in threads:
                t.join(timeout=60)


def train_loader(ds: PairedDicomDataset, batch_size: int, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 2) -> TrainLoader:
    return TrainLoader(ds, batch_size, seed, num_threads, prefetch)


def eval_loader(ds: PairedDicomDataset, batch_size: int = 1) -> Iterator:
    """Sequential batches (reference dataloaders.py:27-41) of
    ``(hu_x, hu_y, paths)``; ``hu_*`` are int16 ``(B, H, W, 1)``."""
    for start in range(0, len(ds), batch_size):
        idxs = range(start, min(start + batch_size, len(ds)))
        pairs = [ds.load(i) for i in idxs]
        yield (np.stack([p[0] for p in pairs])[..., None],
               np.stack([p[1] for p in pairs])[..., None],
               [ds.low_paths[i] for i in idxs])


class prefetch_to_device:  # named as the JAX package's function
    """Iterates ``loader``'s items (tuples of host arrays) as tuples of
    tensors on ``device``, ``size`` items ahead of the consumer (counterpart
    of the JAX ``prefetch_to_device``; reference DataLoader pin_memory +
    ``.to(device)``). On a CUDA device each array is copied into pinned
    host memory, then to the device with ``non_blocking`` copies on a side
    stream; the consumer's stream waits on the copy's event before the
    batch is handed out, and the batch's memory is recorded on that stream,
    so the allocator does not reuse it while the consumer still reads it.
    The pinned buffer stays referenced until its copy's event has been
    waited on, and PyTorch's pinned allocator reuses no block before the
    copies that read it have finished. On the CPU the items pass through
    unchanged. ``len()`` is the loader's."""

    def __init__(self, loader: Iterable, device, size: int = 2):
        self.loader, self.device, self.size = loader, torch.device(device), max(1, size)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator:
        if self.device.type != "cuda":
            yield from self.loader
            return
        stream = torch.cuda.Stream(self.device)
        consumer = torch.cuda.current_stream(self.device)

        def launch(item):
            host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in item]
            with torch.cuda.stream(stream):
                dev = [h.to(self.device, non_blocking=True) for h in host]
                done = torch.cuda.Event()
                done.record(stream)
            return dev, host, done

        items = iter(self.loader)
        pending = collections.deque(launch(it) for it in itertools.islice(items, self.size))
        while pending:
            dev, host, done = pending.popleft()
            consumer.wait_event(done)
            for t in dev:
                t.record_stream(consumer)
            del host
            nxt = next(items, None)
            if nxt is not None:
                pending.append(launch(nxt))
            yield tuple(dev)
