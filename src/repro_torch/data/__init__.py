"""Data: deterministic synthetic batches and the content-addressed sample
store over the port's ``TideDB``."""
