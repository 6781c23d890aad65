"""Serving: continuous batching of LLM decode over the device KV-WAL."""
