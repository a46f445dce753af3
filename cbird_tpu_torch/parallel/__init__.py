"""Sharded search over several devices and processes (``sharded.py``)."""
