"""Engine-facing protocol and KV bookkeeping (pure Python)."""
