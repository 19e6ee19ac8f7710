"""User-facing Speaker API."""
