"""The harness side of each dataset, one module a dataset, found by the
configuration's "dataset" name (:mod:`gpubench.layout`)."""
