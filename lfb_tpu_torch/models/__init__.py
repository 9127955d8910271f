"""Model spec, modules and parameter initialization."""
