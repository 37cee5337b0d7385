"""Shared utilities: the consistent-hash ring (``chash.py``) and the rank
mesh (``mesh.py``)."""
