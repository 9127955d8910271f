"""Evaluation: metrics, the AVA frame-mAP and multi-crop merging (port of
``lfb_tpu/eval/``)."""
