"""Eval step (training is not ported yet)."""
