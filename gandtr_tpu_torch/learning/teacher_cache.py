"""A cache of the frozen HED teacher's distillation targets across epochs
(counterpart of gandtr_tpu/learning/teacher_cache.py), the opt-in
`epoch_iteration.cache_teacher_targets` of HED^N-GAN training.

The E step of every HED^N-GAN step runs the frozen teacher on real_X
(edges_epochs.py:107-121). Where a data pipeline repeats its batches from
epoch to epoch, that forward recomputes what an earlier epoch computed.
The cache keys each batch by the md5 of its host bytes, taken before the
upload (any change of image, order or crop is a new key), keeps the
target maps on the device, and holds at most `max_items` of them, the
least recently used going first.

- A miss runs the step that computes target_M itself (`emit_targets`),
  and stores the map the step computed: no second teacher forward.
- A hit runs the step that takes target_M (`external_targets`) and skips
  the teacher.

The teacher's forward is deterministic under the port's settings, so the
stored map is the one the teacher would compute again, bit for bit, and a
cached run is the uncached run bit for bit.

The published protocol cannot hit: RandomDomainsPair draws new pairs and
scalecrop new crops every epoch, so no batch repeats. The cache is for
deterministic pipelines: PregeneratedImageTuple with a chain that draws
nothing (`centerscalecrop`, say) and an unshuffled loader gives every
epoch the batches of the first.
"""
import hashlib
from collections import OrderedDict

import numpy as np

from gandtr_tpu_torch.device import upload


class TeacherTargetCachingStep:
    """step(state, real_X, real_Y, key) -> (state, metrics, debug), over
    `internal_step` (built with emit_targets) and `external_step` (built
    with external_targets). `batch_to_args(batch)` uploads a host batch to
    `device` and appends its key."""

    def __init__(self, internal_step, external_step, device, max_items=64):
        self.internal_step = internal_step
        self.external_step = external_step
        self.device = device
        self.max_items = int(max_items)
        self._cache = OrderedDict()
        self.hits = 0
        self.misses = 0

    def batch_to_args(self, batch):
        # the key travels with the batch's tensors, never through state of
        # the cache, so no prefetch can pair a key with another batch
        xb = np.ascontiguousarray(batch[0])
        key = hashlib.md5(xb.tobytes()).hexdigest()
        return (upload(xb, self.device), upload(batch[1], self.device), key)

    def __call__(self, state, real_X, real_Y, key=None):
        target = self._cache.get(key) if key is not None else None
        if target is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return self.external_step(state, real_X, real_Y, target)
        state, metrics, debug = self.internal_step(state, real_X, real_Y)
        self.misses += 1
        debug = dict(debug)
        target = debug.pop("target_M")
        if key is not None:
            self._cache[key] = target
            while len(self._cache) > self.max_items:
                self._cache.popitem(last=False)
        return state, metrics, debug
