"""File readers with partition, limit and key selectors (counterpart of
gandtr_tpu/utils/file_readers.py; the reference's
mdir/external/daan/data/file_readers.py).

Rows are kept where `index % partitions == slice`, up to `limit`; arrays
take `[slice(slice, limit, partitions)]`. Formats: tsv / csv (also .gz /
.xz; a header row; cells in brackets decode as JSON), pkl, h5 (keys from
attrs["header"]; h5py is imported when an h5 file opens), lst (`[a|b]` in
the path expands to one column each) and json, and the `path#a:b` row
range.
"""
import abc
import gzip
import json
import lzma
import pickle
import re
import time
from collections import OrderedDict

import numpy as np


class InputSelector:
    """Row/column selector (file_readers.py:17-31)."""

    def __init__(self, *, slice=0, partitions=1, limit=None, keys=None):  # noqa: A002
        if not 0 <= slice < partitions:
            raise ValueError("slice %d outside [0, %d)" % (slice, partitions))
        self.slice = slice
        self.partitions = partitions
        self.limit = limit
        self.keys = keys

    @property
    def slicing(self):
        return slice(self.slice, self.limit, self.partitions)


def str2collection(value):
    """JSON-decode bracketed cell strings; empty string -> None
    (file_readers.py:89-97)."""
    if isinstance(value, str) and not value:
        return None
    if isinstance(value, str) and value and (
            (value[0], value[-1]) == ("[", "]") or
            (value[0], value[-1]) == ("{", "}")):
        return json.loads(value)
    return value


class GenericReader(metaclass=abc.ABCMeta):
    """Context-managed reader with retrying open (file_readers.py:34-87)."""

    retry = 3
    retry_sleep = None  # None -> the reference's (i+1)^3 seconds

    def __init__(self, path, selector):
        self.path = path
        self.handle = None
        self.selector = selector

    @abc.abstractmethod
    def get(self):
        """Get all data at once."""

    def open(self):
        for i in range(self.retry + 1):
            try:
                return self._open()
            except (FileNotFoundError, OSError, EOFError):
                if i == self.retry:
                    raise ValueError("Error with path '%s' (try %s)"
                                     % (self.path, i + 1))
                time.sleep(self.retry_sleep if self.retry_sleep is not None
                           else (i + 1) ** 3)

    def _open(self):
        fopen = lzma.open if self.path.endswith(".xz") else \
            gzip.open if self.path.endswith(".gz") else open
        self.handle = fopen(self.path, "rb")

    def close(self):
        self.handle.close()

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, exc_type, exc, exc_tb):
        self.close()

    def _iter_selected_lines(self, handle):
        """Partition/limit row filter shared by tsv/lst (file_readers.py
        :122-131, 199-207)."""
        index = 0
        for line in handle:
            if index % self.selector.partitions == self.selector.slice:
                yield line.decode("utf8")
            index += 1
            if self.selector.limit and index >= self.selector.limit:
                break


class TsvReader(GenericReader):
    """.tsv/.csv (+.gz/.xz) with a header row (file_readers.py:100-133)."""

    VALID_SUFFIXES = [".tsv", ".tsv.gz", ".tsv.xz", ".csv", ".csv.gz",
                      ".csv.xz"]

    def __init__(self, path, selector):
        super().__init__(path, selector)
        assert sum(path.endswith(x) for x in self.VALID_SUFFIXES)
        self.header = None
        self.separator = "\t" if "tsv" in path.rsplit(".", 2) else ","

    def open(self):
        super().open()
        self.header = next(self.handle).decode("utf8").strip() \
            .split(self.separator)

    def get(self):
        indexes = list(range(len(self.header)))
        if self.selector.keys:
            indexes = [self.header.index(x) for x in self.selector.keys]
        acc = [[] for _ in indexes]
        for line in self._iter_selected_lines(self.handle):
            cells = line.strip("\n").split(self.separator)
            for i, j in enumerate(indexes):
                acc[i].append(str2collection(cells[j]))
        return OrderedDict(zip([self.header[i] for i in indexes], acc))


class PklReader(GenericReader):
    """.pkl of a column dict (file_readers.py:136-147)."""

    def __init__(self, path, selector):
        super().__init__(path, selector)
        assert path.endswith(".pkl")

    def get(self):
        data = pickle.load(self.handle)
        keys = self.selector.keys or data.keys()
        return OrderedDict((x, data[x][self.selector.slicing]) for x in keys)


class Hdf5Reader(GenericReader):
    """.h5 with an attrs['header'] key list (file_readers.py:150-174)."""

    def __init__(self, path, selector):
        super().__init__(path, selector)
        assert path.endswith(".h5")

    def _open(self):
        import h5py
        self.handle = h5py.File(self.path, "r")

    def _get_column(self, key):
        data = self.handle[key][self.selector.slicing]
        if data.dtype == object:
            return [x.decode("utf8") if isinstance(x, bytes) else x
                    for x in data.tolist()]
        return data

    def get(self):
        if self.selector.keys is None:
            keys = [x.decode("utf8") if isinstance(x, bytes) else x
                    for x in self.handle.attrs["header"]]
        else:
            keys = self.selector.keys
        return OrderedDict((x, self._get_column(x)) for x in keys)


class LstReader(GenericReader):
    """.lst one-value-per-line; `[a|b]` in the path expands to one column per
    alternative (file_readers.py:177-216)."""

    def __init__(self, path, selector):
        super().__init__(path, selector)
        assert path.endswith(".lst")
        hit = re.search(r"\[([a-zA-Z0-9_|]+)\]", path)
        if not hit:
            self.path = {"item": path}
        else:
            hit = hit.group(1)
            self.path = OrderedDict(
                (x, path.replace("[%s]" % hit, x)) for x in hit.split("|"))

    def _open(self):
        self.handle = {x: open(y, "rb") for x, y in self.path.items()}

    def close(self):
        for handle in self.handle.values():
            handle.close()

    def _get_column(self, key):
        return [str2collection(line.strip("\n"))
                for line in self._iter_selected_lines(self.handle[key])]

    def get(self):
        keys = self.selector.keys if self.selector.keys is not None \
            else list(self.path.keys())
        return OrderedDict((x, self._get_column(x)) for x in keys)


class JsonReader(GenericReader):
    """.json column dict — extension beyond the reference's formats."""

    def __init__(self, path, selector):
        super().__init__(path, selector)

    def get(self):
        data = json.load(self.handle)
        keys = self.selector.keys or data.keys()
        sl = self.selector.slicing
        return OrderedDict(
            (x, data[x][sl] if isinstance(data[x], (list, np.ndarray))
             else data[x]) for x in keys)


READERS = {
    "tsv": TsvReader,
    "csv": TsvReader,
    "pkl": PklReader,
    "h5": Hdf5Reader,
    "lst": LstReader,
    "json": JsonReader,
}


class _RangeWrapped:
    """`path#a:b` sugar: post-hoc row range over the reader's columns."""

    def __init__(self, reader, start, stop):
        self._reader = reader
        self._range = slice(start, stop)

    def __enter__(self):
        self._reader.open()
        return self

    def __exit__(self, *exc):
        self._reader.close()

    def get(self):
        data = self._reader.get()
        return OrderedDict((k, v[self._range]) for k, v in data.items())


def initialize_file_reader(path, **kwargs):
    """Suffix-dispatched reader; kwargs are InputSelector opts
    (file_readers.py:219-237). `path#a:b` row-range sugar kept from our
    earlier API."""
    rng = None
    if "#" in path:
        path, sel = path.rsplit("#", 1)
        a, _, b = sel.partition(":")
        rng = (int(a) if a else None, int(b) if b else None)
    base, suffix = path.rsplit(".", 1)
    if suffix in ["gz", "xz"]:
        suffix = base.rsplit(".", 1)[1]
    if suffix not in READERS:
        raise ValueError("Suffix '%s' is not supported ('%s')"
                         % (suffix, path))
    reader = READERS[suffix](path, InputSelector(**kwargs))
    if rng is not None:
        return _RangeWrapped(reader, *rng)
    return reader
