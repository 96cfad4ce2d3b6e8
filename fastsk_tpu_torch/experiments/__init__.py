"""Experiments on the port's kernels (``probe_pairs.py``: kernel H;
``ptxas_report.py``: what ptxas makes of kernels A and H) and on its
baselines (``dl_seeds.py``: their AUC across seeds)."""
