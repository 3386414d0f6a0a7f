"""Adapters from a configuration to the port's public API, one file an
index kind (the configuration's ``index``)."""
