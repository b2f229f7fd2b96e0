"""Scenario stages (counterpart of gandtr_tpu/scenarios). Ported so far:
the GeM fine-tune step (finetune_build.py)."""
