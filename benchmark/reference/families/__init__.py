"""The reference's encoders, one file a family, each found by the name of
a configuration's ``arch["family"]`` (reference/nets.py)."""
