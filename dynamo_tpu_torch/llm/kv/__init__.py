"""KV cache bookkeeping: block pool, prefix reuse, cache events."""
