"""Eclat vertical-mining plane (packed tid-list columns + AND-popcount)."""
from repro_torch.mining.eclat.miner import EclatMiner, columnize_cost

__all__ = ["EclatMiner", "columnize_cost"]
