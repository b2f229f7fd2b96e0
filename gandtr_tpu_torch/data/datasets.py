"""Image loading (counterpart of gandtr_tpu/data/datasets.py::imread).

PIL decodes; the JAX package's native libjpeg decoder and its `store.h5#key`
form are not ported yet. The two decoders give equal arrays on the same
JPEGs (tests/test_torch_eval.py holds it), so descriptors do not depend on
which one ran.
"""
from PIL import Image, ImageFile

ImageFile.LOAD_TRUNCATED_IMAGES = True


def imread(path, mode="RGB"):
    """A PIL image of `path`, converted to `mode`."""
    if ".h5#" in path:
        raise NotImplementedError("h5 image stores (%r) are not ported yet"
                                  % path)
    with open(path, "rb") as f:
        return Image.open(f).convert(mode)
