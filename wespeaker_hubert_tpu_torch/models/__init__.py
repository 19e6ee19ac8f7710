"""Speaker-embedding backbones, pooling, registry and weight conversion."""
