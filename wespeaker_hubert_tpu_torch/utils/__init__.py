"""Device selection, kernel builds and throughput accounting."""
