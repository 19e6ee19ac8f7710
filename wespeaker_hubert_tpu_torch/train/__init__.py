"""Embedding extraction: chunked serving path and eval executor."""
