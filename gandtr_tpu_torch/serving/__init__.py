"""Serving (counterpart of gandtr_tpu/serving/): exported artifacts
(`serving.export`), the batching HTTP service (`serving.service`) and the
retrieval indexes behind `:search` (`serving.index`, `serving.pq`)."""
import numpy as _np

from gandtr_tpu_torch.serving.export import (  # noqa: F401
    ArtifactServable, Servable, export_hub_model, export_sharded_model,
    load_artifact)
from gandtr_tpu_torch.serving.index import RetrievalIndex  # noqa: F401
from gandtr_tpu_torch.serving.pq import PQRetrievalIndex  # noqa: F401
from gandtr_tpu_torch.serving.service import (  # noqa: F401
    BatchingService, serve_http)


def load_index(path, devices=None):
    """Load a saved index (of either package), exact or PQ by the arrays
    in the .npz: both formats are pickle-free."""
    p = path if str(path).endswith(".npz") else str(path) + ".npz"
    with _np.load(p) as z:
        is_pq = "codes" in z.files
    cls = PQRetrievalIndex if is_pq else RetrievalIndex
    return cls.load(p, devices=devices)
