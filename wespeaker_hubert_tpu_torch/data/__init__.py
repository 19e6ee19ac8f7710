"""Host-side data I/O."""
