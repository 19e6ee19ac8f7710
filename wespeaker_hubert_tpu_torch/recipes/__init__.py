"""Recipes: the port's counterparts of `examples/*/run.py`."""
