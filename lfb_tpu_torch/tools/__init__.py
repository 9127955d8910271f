"""The reference-style command lines of the port, run as
``python -m lfb_tpu_torch.tools.<name>``."""
