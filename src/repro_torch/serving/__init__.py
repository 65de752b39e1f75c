"""Serving over a tiered KV cache: the cache, the shared-prefix pool,
samplers and the batched engine."""
