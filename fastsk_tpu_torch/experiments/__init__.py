"""Experiments on the port's kernels (``probe_pairs.py``: kernel H)."""
