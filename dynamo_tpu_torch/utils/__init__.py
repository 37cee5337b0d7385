"""Shared utilities: the consistent-hash ring (``chash.py``)."""
