"""Scenario stages (counterpart of gandtr_tpu/scenarios). Ported so far:
the GeM fine-tune step (finetune_build.py) and the validate stage's
retrieval eval (validate_stage.py, with infer_stage.py's network loader)."""
