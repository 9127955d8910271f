"""Config keys, defaults and finalization."""
