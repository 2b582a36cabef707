"""Optimisers over trees of tensors: AdamW with its schedule and
global-norm clipping (the reference's ``repro/optim/adamw.py``), and
gradient compression (``compression.py``)."""
