"""Evaluation: metrics, the AVA frame-mAP, multi-crop merging and EPIC's
action scores (port of ``lfb_tpu/eval/``)."""
