"""The model stack: configuration, layers, the dense transformer and its
serving paths over the device KV-WAL."""
