"""Scenario stages and the scenario CLI (counterpart of
gandtr_tpu/scenarios): the YAML engine (engine.py) and runner (run.py),
the train stage (train_stage.py on build.py's GAN families and
finetune_build.py's GeM fine-tune), the infer stage (infer_stage.py:
embedding and image outputs), the whitening stages (stages.py,
multistep_stage.py) and the validate stage's retrieval eval
(validate_stage.py)."""
