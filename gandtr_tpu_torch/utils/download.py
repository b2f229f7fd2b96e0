"""Checks of the data layout the scenarios read (counterpart of
gandtr_tpu/utils/download.py; the reference's mdir/tools/download.py and
cirtorch's utils/download.py).

This package downloads nothing. Each function checks that the files the
JAX package would fetch are where it would put them, under `data_dir`
(the scenarios' `$GANDTR_ROOT/data`), and raises FileNotFoundError
listing every missing path with the address the file is published at.
The one local step is kept: `rsfm120k` links the four validation photos
of the GAN's visual validation, `val/day_night/{1..4}.jpg`, to their
SfM-120k images.

    data/train/retrieval-SfM-120k/{retrieval-SfM-120k.pkl,
        retrieval-SfM-120k-whiten.pkl, dataset/train_day.txt,
        dataset/train_night.txt, ims/}
    data/test/{roxford5k,rparis6k,247tokyo1k}/{gnd_<name>.pkl, jpg/*.jpg}
"""
import glob
import os

ICCV23_URL = "http://ptak.felk.cvut.cz/personal/jenicto2/download/iccv23_gan/"
CMP_URL = "http://cmp.felk.cvut.cz/cnnimageretrieval/data/"

VAL_IMS = [
    "8a/b3/ab/3fb7b4f3c9560312f1e36f00a7abb38a",
    "39/f6/93/015bb8aa57c3fbebc41daca6a093f639",
    "37/67/5f/0030a526c20a135a33e93d0d495f6737",
    "81/fd/18/d543f7828509ebc931c80134b818fd81",
]
TEST_SETS = ("roxford5k", "rparis6k", "247tokyo1k")
#: where each test set's photos are published, for the message
TEST_IMAGES = {
    "roxford5k": "the Oxford buildings images (oxbuild_images)",
    "rparis6k": "the Paris buildings images (paris_1, paris_2)",
    "247tokyo1k": "the Tokyo 24/7 query and database images",
}


def _raise_missing(missing):
    if missing:
        raise FileNotFoundError(
            "missing data (this package downloads nothing; place each file "
            "at its path):\n" + "\n".join("  %s  <- %s" % m for m in missing))


def rsfm120k(data_dir):
    """Retrieval-SfM-120k's database pickles, its images, and the day /
    night lists of the GAN training; links the validation photos."""
    dbs = os.path.join(data_dir, "train", "retrieval-SfM-120k")
    missing = []
    for name in ("retrieval-SfM-120k.pkl", "retrieval-SfM-120k-whiten.pkl"):
        missing.append((os.path.join(dbs, name),
                        CMP_URL + "train/dbs/" + name))
    for name in ("train_day.txt", "train_night.txt"):
        missing.append((os.path.join(dbs, "dataset", name), ICCV23_URL + name))
    missing.append((os.path.join(dbs, "ims") + "/",
                    CMP_URL + "train/ims/ims.tar.gz"))
    missing = [m for m in missing if not os.path.exists(m[0])]
    ims = os.path.join(dbs, "ims")
    if os.path.isdir(ims):
        val_dir = os.path.join(data_dir, "val", "day_night")
        os.makedirs(val_dir, exist_ok=True)
        for i, img in enumerate(VAL_IMS, 1):
            src = os.path.join(ims, img)
            dest = os.path.join(val_dir, "%d.jpg" % i)
            if os.path.exists(src) and not os.path.lexists(dest):
                os.symlink(src, dest)
    _raise_missing(missing)


def roxf5k_rpar6k_247tokyo1k(data_dir):
    """Each test set's ground-truth pickle and its photos under jpg/."""
    missing = []
    for ds in TEST_SETS:
        root = os.path.join(data_dir, "test", ds)
        gnd = os.path.join(root, "gnd_%s.pkl" % ds)
        if not os.path.exists(gnd):
            missing.append((gnd, CMP_URL + "test/%s/gnd_%s.pkl" % (ds, ds)
                            if ds != "247tokyo1k" else
                            "the Tokyo 24/7 ground truth in the reference's "
                            "gnd pickle form"))
        jpg = os.path.join(root, "jpg")
        if not glob.glob(os.path.join(jpg, "*.jpg")):
            missing.append((jpg + "/*.jpg", TEST_IMAGES[ds]))
    _raise_missing(missing)
