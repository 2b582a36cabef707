"""Streaming plane: incremental Apriori over a sliding transaction window,
feeding live rule-index refreshes into the serving plane (the closed loop
the paper's continuously-operating system implies)."""
from repro_torch.streaming.miner import (BatchReport, StreamingConfig,
                                         StreamingMiner, StreamingReport)
from repro_torch.streaming.source import SlidingWindow, TransactionStream

__all__ = [
    "BatchReport", "SlidingWindow", "StreamingConfig", "StreamingMiner",
    "StreamingReport", "TransactionStream",
]
