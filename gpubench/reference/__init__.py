"""The plain reference: float32 PyTorch, TF32 off, imports nothing of the
program under test."""
