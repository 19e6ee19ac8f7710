"""Entry points: the embedding server."""
