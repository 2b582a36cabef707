"""PyTorch/CUDA port of the heterogeneous market-basket mining system.

Mirrors the ``repro`` package module for module; the mining main path
(``ingest_baskets`` → ``MarketBasketPipeline.run`` → ``generate_rules``)
runs on an NVIDIA Hopper card through hand-written CUDA kernels, or on the
CPU through their plain PyTorch versions when the caller asks for it.
"""
