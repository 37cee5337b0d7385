"""KV cache bookkeeping: block pool, prefix reuse, cache events, the host and
persistent tiers, and the transfer plane."""
