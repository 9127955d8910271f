"""The reference side of each dataset, one module a dataset: which bank
rows an example's window holds, and the loss.  Imports nothing of the
program under test."""
