"""Image loading, the image-list, tuple and GAN datasets and the batch
loader (counterpart of gandtr_tpu/data/datasets.py::imread, ::path_join,
::ImageListDataset, ::InferImageListDataset, ::RandomImageTupleDataset,
::PregeneratedImageTupleDataset, ::RandomDomainsPairDataset and ::Loader).

An item is a tuple of numpy images (InferImageList's a pair of its names
and its images), so `stack_collate` makes a batch of each position. A
dataset whose images are known before they are decoded has `plan(i)`: it
makes item i's transform draws from the images' header sizes, and the
loader calls it for its items in order, so a pool of threads gives every
item the draws of the sequential loop.

`imread` decodes RGB images with the native decoder (native/, libjpeg
and libpng on a C++ thread pool) where it built, else with PIL; the two
give equal arrays (tests/test_torch_native_loader.py), so nothing
downstream depends on which one ran. `GANDTR_TPU_NATIVE_LOADER=0` turns
the native path off, as in the JAX package. A path `store.h5#key` reads
the image from an HDF5 store (the reference's h5 image storage), through
a cache of read handles.
"""
import os
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, ImageFile

ImageFile.LOAD_TRUNCATED_IMAGES = True


# the native decode path, on by default (GANDTR_TPU_NATIVE_LOADER=0 off)
_NATIVE_OK = os.environ.get("GANDTR_TPU_NATIVE_LOADER", "1") != "0"

# Read handles of h5 stores: the loader's threads read a store once an
# image an epoch, and opening the file each time pays HDF5's metadata cost
# every time. h5py is not thread-safe without a thread-safe HDF5 build, so
# the reads serialize under one lock (the decode dominates, not the read).
_H5_HANDLES = {}
_H5_LOCK = threading.Lock()


def _h5_read(h5path, key):
    import h5py
    with _H5_LOCK:
        f = _H5_HANDLES.get(h5path)
        if f is None:
            f = _H5_HANDLES[h5path] = h5py.File(h5path, "r")
        try:
            return np.asarray(f[key])
        except KeyError:
            # the store may have been written again since it was opened:
            # reopen it once before failing
            _H5_HANDLES.pop(h5path).close()
            f = _H5_HANDLES[h5path] = h5py.File(h5path, "r")
            return np.asarray(f[key])


def imread(path, mode="RGB"):
    """A PIL image of `path`, converted to `mode`; `store.h5#key` reads
    dataset `key` of an h5 store."""
    if ".h5#" in path:
        h5path, key = path.split("#", 1)
        return Image.fromarray(_h5_read(h5path, key)).convert(mode)
    if _NATIVE_OK and mode == "RGB":
        from gandtr_tpu_torch import native
        if native.available():
            arr = native.decode(path)
            if arr is not None:
                return Image.fromarray(arr)
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


def _items(images):
    """A transform's output (one image or a list) as a tuple of arrays."""
    if not isinstance(images, (list, tuple)):
        images = (images,)
    return tuple(np.asarray(im) for im in images)


class _Planned:
    """`plan(i)` for a dataset with `_paths(i)` and `transform`: the draws
    of item i from its images' header sizes, kept until it is loaded."""

    def plan(self, idx):
        if self.transform is not None and hasattr(self.transform, "draw"):
            sizes = []
            for path in self._paths(idx):
                with Image.open(path) as im:
                    sizes.append((im.size[1], im.size[0]))
            self._draws[idx] = self.transform.draw(sizes)

    def _transformed(self, idx, mode="RGB"):
        """Item idx's images through the transform, with their planned
        draws: as the transform returns them."""
        images = [imread(p, mode) for p in self._paths(idx)]
        if self.transform:
            images = self.transform(*images,
                                    draws=self._draws.pop(idx, None))
        return images

    def _load(self, idx, mode="RGB"):
        return _items(self._transformed(idx, mode))


class ImageListDataset(_Planned):
    """Images from parallel name lists (tuple_datasets.py:19-40): `data`
    holds one list of names per position; item i is the tuple of the
    i-th names' images, transformed together."""

    loader_params = {}

    def __init__(self, data, transform, image_dir, mode=None):
        if len({len(x) for x in data}) != 1:
            raise ValueError("name lists of different lengths")
        self.image_list = [[path_join(image_dir, x) for x in y]
                           for y in zip(*data)]
        self.transform = transform
        self.mode = mode
        self._draws = {}

    def __len__(self):
        return len(self.image_list)

    def _paths(self, idx):
        return self.image_list[idx]

    def __getitem__(self, idx):
        return self._load(idx, self.mode or "RGB")


class InferImageListDataset(ImageListDataset):
    """Named images from parallel name lists (tuple_datasets.py:43-60):
    item i is ((names), images), the images as the transform returns them
    (one image for one list, as the JAX package's variadic Compose)."""

    def __init__(self, data, transform, image_dir, mode=None):
        super().__init__(data, transform, image_dir, mode)
        self.data = [list(x) for x in zip(*data)]

    def __getitem__(self, idx):
        return tuple(self.data[idx]), self._transformed(idx,
                                                        self.mode or "RGB")


class RandomImageTupleDataset(_Planned):
    """Tuples of images drawn from rows of candidates
    (tuple_datasets.py:63-122). `dataset` (a file the readers of
    utils/file_readers.py take, or a dict) holds under `data_key` one list
    of candidate names a row; `idx` says how each position of a row's
    tuple picks among them: an int (negative from the end), "any", or
    "different" (any not picked yet in the tuple), or a [start, end)
    range; the string form joins them with "_" ("0_any"). Each epoch
    (`prepare_epoch`) draws the tuples anew from `rng`, numpy's global RNG
    by default, as the reference; a range's ends reach its `randint` as
    written (a negative start too), as there."""

    loader_params = {}

    def __init__(self, data, transform, dataset, data_key, image_dir, idx,
                 rng=None):
        if data:
            raise ValueError("%s takes no data" % type(self).__name__)
        self.image_list = [[path_join(image_dir, y) for y in x]
                           for x in self._read_dataset(dataset, data_key)]
        self.transform = transform
        if isinstance(idx, str):
            idx = [x if x in {"any", "different"} else int(x)
                   for x in idx.split("_")]
        self.idx = idx
        self.epoch_images = None
        self._rng = rng or np.random
        self._draws = {}

    @staticmethod
    def _read_dataset(dataset, data_key):
        if isinstance(dataset, dict):
            return dataset[data_key]
        from gandtr_tpu_torch.utils.file_readers import initialize_file_reader
        with initialize_file_reader(dataset, keys=[data_key]) as reader:
            return reader.get()[data_key]

    @staticmethod
    def get_idx(idx, length, previous_idxs, rand):
        if idx == "any":
            return rand(length)
        if idx == "different":
            idxs = [x for x in range(length) if x not in previous_idxs]
            return idxs[rand(len(idxs))]
        if isinstance(idx, (list, tuple)):
            for end in idx:
                if end is not None and not 0 <= (length + end if end < 0
                                                 else end) < length:
                    raise IndexError("index range %s of %d candidates"
                                     % (idx, length))
            return rand(idx[0] or 0, idx[1] or length)
        if idx < 0:
            idx = length + idx
        if not 0 <= idx < length:
            raise IndexError("index %s of %d candidates" % (idx, length))
        return idx

    def _generate_epoch_images(self, rand):
        self.epoch_images = []
        for possible in self.image_list:
            idxs = []
            for i in self.idx:
                idxs.append(self.get_idx(i, len(possible), idxs, rand))
            self.epoch_images.append([possible[j] for j in idxs])
        self._draws = {}

    def prepare_epoch(self):
        self._generate_epoch_images(self._rng.randint)

    def __len__(self):
        return len(self.image_list)

    def _paths(self, idx):
        return self.epoch_images[idx]

    def __getitem__(self, idx):
        return self._load(idx)


class PregeneratedImageTupleDataset(RandomImageTupleDataset):
    """RandomImageTuple drawn once, from `random.Random(0)`, and the same
    every epoch (tuple_datasets.py:125-135): the deterministic pipeline a
    resumed run repeats, and the one whose batches the teacher cache sees
    again."""

    def __init__(self, data, transform, dataset, data_key, image_dir, idx):
        super().__init__(data, transform, dataset, data_key, image_dir, idx)
        self._generate_epoch_images(random.Random(0).randrange)

    def prepare_epoch(self):
        pass


class RandomDomainsPairDataset(_Planned):
    """Unpaired domain pairs (domain_datasets.py:10-58): each epoch
    (`prepare_epoch`) draws `size` images of domain X and `size` of domain
    Y from numpy's global RNG, as the reference does; item i is the pair
    (X_i, Y_i), transformed together (a scalecrop cuts both alike)."""

    loader_params = {}

    def __init__(self, data, transform, dataset_X, dataset_Y, image_dir,
                 size, image_dir_Y=None, rng=None):
        if data:
            raise ValueError("RandomDomainsPair takes no data")
        image_dir_Y = image_dir if image_dir_Y is None else image_dir_Y
        self.images_X = [path_join(image_dir, x)
                         for x in self._read_list(dataset_X)]
        self.images_Y = [path_join(image_dir_Y, y)
                         for y in self._read_list(dataset_Y)]
        self.transform = transform
        self.size = int(size) if size is not None else min(
            len(self.images_X), len(self.images_Y))
        self._rng = rng or np.random
        self.idxs_X = self.idxs_Y = None
        self._draws = {}

    @staticmethod
    def _read_list(path_or_list):
        if isinstance(path_or_list, (list, tuple)):
            return list(path_or_list)
        with open(path_or_list) as f:
            return [x.strip() for x in f.readlines()]

    def prepare_epoch(self):
        self.idxs_X = list(self._rng.randint(len(self.images_X),
                                             size=self.size))
        self.idxs_Y = list(self._rng.randint(len(self.images_Y),
                                             size=self.size))
        self._draws = {}

    def __len__(self):
        return self.size

    def _paths(self, idx):
        return (self.images_X[self.idxs_X[idx]],
                self.images_Y[self.idxs_Y[idx]])

    def __getitem__(self, idx):
        return self._load(idx)


def _lazy_cir(name):
    def build(data, transform, **params):
        from gandtr_tpu_torch.data import cir_datasets
        return getattr(cir_datasets, name)(data, transform, **params)
    return build


DATASET_LABELS = {
    "ImageList": ImageListDataset,
    "InferImageList": InferImageListDataset,
    "RandomImageTuple": RandomImageTupleDataset,
    "PregeneratedImageTuple": PregeneratedImageTupleDataset,
    "RandomDomainsPair": RandomDomainsPairDataset,
    "CirTuples": _lazy_cir("cir_tuples_dataset"),
    "CirDiverseAnchors": _lazy_cir("cir_diverse_anchors_dataset"),
    "CirImageList": _lazy_cir("CirImageListDataset"),
}


def initialize_dataset_loader(data, params, loader_defaults=None):
    """A dataset and its Loader from a reference-style config ({dataset:
    {name, ...}, loader: {...}, transforms, mean_std}), as
    dataset/__init__.py:8-41: the loader's settings are the defaults, then
    the dataset's, then the config's. Paths are `resolve_path`ed."""
    from gandtr_tpu_torch.data.transforms import initialize_transforms
    from gandtr_tpu_torch.utils.io import resolve_path
    params = dict(params)
    dparams = dict(params.pop("dataset"))
    user_loader = dict(params.pop("loader", None) or {})
    transforms = None
    if "transforms" in params:
        transforms = initialize_transforms(params.pop("transforms"),
                                           params.pop("mean_std"))
    name = dparams.pop("name")
    if name not in DATASET_LABELS:
        raise NotImplementedError("dataset %r is not ported yet" % name)
    # the cir datasets resolve their own paths (their `dataset` is a name)
    for key in () if name.startswith("Cir") else (
            "dataset", "dataset_X", "dataset_Y", "image_dir", "image_dir_Y"):
        if isinstance(dparams.get(key), str):
            dparams[key] = resolve_path(dparams[key])
    dataset = DATASET_LABELS[name](data, transforms, **dparams)
    lparams = {"num_workers": 6, **(loader_defaults or {}),
               **dataset.loader_params, **user_loader}
    lparams.pop("pin_memory", None)
    return Loader(dataset, **lparams)


class Loader:
    """Thread-pool prefetch batch loader (counterpart of the JAX package's
    `Loader`, which stands in for torch's DataLoader workers).

    Each epoch's order is a permutation drawn from the loader's own
    `numpy.random.RandomState(seed)` when `shuffle`; `drop_last` drops a
    short last batch. `num_workers` threads build up to `prefetch + 1`
    batches ahead of the consumer; a dataset with `plan(i)` has it called
    for each item, in order, before the item is handed to a thread. A
    batch stacks each position of its items; it stays numpy, and the
    caller uploads it."""

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
        plan = getattr(self.dataset, "plan", None)

        def submit(ex, b):
            if plan is not None:
                for i in b:
                    plan(int(i))
            return ex.submit(self._batch, b)

        with ThreadPoolExecutor(self.num_workers) as ex:
            futures = deque(submit(ex, b)
                            for b in batches[:self.prefetch + 1])
            for b in batches[self.prefetch + 1:]:
                done = futures.popleft()
                futures.append(submit(ex, b))
                yield done.result()
            while futures:
                yield futures.popleft().result()


def stack_collate(items):
    """Stack each position of the items: [(a1, b1), (a2, b2)] ->
    (stack(a), stack(b)); a position that is not an array (the names of
    InferImageList) stays a list."""
    return tuple(np.stack(col) if isinstance(col[0], np.ndarray)
                 else list(col) for col in zip(*items))
