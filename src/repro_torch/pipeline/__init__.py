"""End-to-end market-basket pipeline (paper §V composed as one object)."""
from repro_torch.pipeline.dataplane import (DataPlane, resolve_backend,
                                            uniform_tiles)
from repro_torch.pipeline.pipeline import (MarketBasketPipeline,
                                           PipelineConfig, PipelineResult,
                                           ingest_baskets)
from repro_torch.pipeline.report import (PipelineReport, RoundReport,
                                         SerialPhase)

__all__ = [
    "DataPlane", "MarketBasketPipeline", "PipelineConfig", "PipelineReport",
    "PipelineResult", "RoundReport", "SerialPhase", "ingest_baskets",
    "resolve_backend", "uniform_tiles",
]
