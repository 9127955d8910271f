"""Eval and train steps, the optimizer, the LR schedule and the checkpoint
helpers."""
