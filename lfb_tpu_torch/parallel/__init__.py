"""Data parallelism over ``torch.distributed``: the process group helpers
(:mod:`.mesh`) and the command lines' launcher (:mod:`.launch`)."""
