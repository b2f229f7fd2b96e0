"""Image loading and the batch loader (counterpart of
gandtr_tpu/data/datasets.py::imread, ::path_join and ::Loader).

PIL decodes; the JAX package's native libjpeg decoder and its `store.h5#key`
form are not ported yet. The two decoders give equal arrays on the same
JPEGs (tests/test_torch_eval.py holds it), so descriptors do not depend on
which one ran.
"""
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, ImageFile

ImageFile.LOAD_TRUNCATED_IMAGES = True


def imread(path, mode="RGB"):
    """A PIL image of `path`, converted to `mode`."""
    if ".h5#" in path:
        raise NotImplementedError("h5 image stores (%r) are not ported yet"
                                  % path)
    with open(path, "rb") as f:
        return Image.open(f).convert(mode)


def path_join(directory, name, default_extension=".jpg"):
    """The reference's path_join (daan ml/tools.py:26-48): an absolute name
    passes through; a '*' in the directory splits off an extension
    candidate; 'ext!' replaces the name's extension (a plain 'ext' applies
    only to a name without one); an extension-less name under a '*'-free
    directory gets `default_extension`. None directory = ''."""
    directory = directory or ""
    if name and name[0] == "/":
        return name
    ext = default_extension
    path = directory
    if "*" in path:
        path, ext = path.rsplit("*", 1)
    if "/" not in ext:
        if ext and ext[-1] == "!":
            ext = ext[:-1]
            if ext:
                name = name.rsplit(".", 1)[0]
        elif "." in name.rsplit("/", 1)[-1] and name.rsplit(".", 1)[-1]:
            ext = ""
    return os.path.join(path, name + ext)


class Loader:
    """Thread-pool prefetch batch loader (counterpart of the JAX package's
    `Loader`, which stands in for torch's DataLoader workers).

    Each epoch's order is a permutation drawn from the loader's own
    `numpy.random.RandomState(seed)` when `shuffle`; `drop_last` drops a
    short last batch. `num_workers` threads build up to `prefetch + 1`
    batches ahead of the consumer. A batch stacks each position of its
    items; it stays numpy, and the caller uploads it."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 num_workers=6, seed=0, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.rng = np.random.RandomState(seed)
        # batches in flight; a chunked train loop raises it so the decode
        # threads stay busy while the card runs a chunk of steps
        self.prefetch = int(prefetch)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batch(self, idxs):
        return stack_collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.num_workers <= 1:
            for b in batches:
                yield self._batch(b)
            return
        with ThreadPoolExecutor(self.num_workers) as ex:
            futures = deque(ex.submit(self._batch, b)
                            for b in batches[:self.prefetch + 1])
            for b in batches[self.prefetch + 1:]:
                done = futures.popleft()
                futures.append(ex.submit(self._batch, b))
                yield done.result()
            while futures:
                yield futures.popleft().result()


def stack_collate(items):
    """Stack each position of the items: [(a1, b1), (a2, b2)] ->
    (stack(a), stack(b))."""
    return tuple(np.stack(col) for col in zip(*items))
