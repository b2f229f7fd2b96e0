"""Retrieval evaluation (counterpart of gandtr_tpu/eval)."""
