"""Evaluation metrics of the port (counterpart of `arttts_tpu/eval/`)."""
