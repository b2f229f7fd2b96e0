"""Tuple datasets of the GeM fine-tune (counterpart of
gandtr_tpu/data/cir_datasets.py). Ported so far: the bucket size."""


def generator_safe_bucket(image_size):
    """The padded-bucket side of tuple batches: rounded up to a multiple of
    4, so the 2x-down / 2x-up ResNet generator maps the bucket onto itself
    (the reference feeds 362 and embeds the generator's 364 output)."""
    return -(-int(image_size) // 4) * 4
