"""HTTP serving of the port: the engine (``server.py``), the versioned
model lifecycle (``lifecycle.py``), and the standard scorers, the fleet
client and partition consolidation (``fleet.py``)."""

from mmlspark_tpu_torch.serving.fleet import (
    PartitionConsolidator, ServingFleet, ServingUnavailable,
    json_row_scoring_pipeline, json_scoring_pipeline,
)
from mmlspark_tpu_torch.serving.lifecycle import (
    CanaryPolicy, ModelRegistry, SwapEvent, SwapInProgress, SwapResult,
)
from mmlspark_tpu_torch.serving.server import (
    HTTPSource, PipelineHandle, ServingEngine, SharedSingleton,
    SharedVariable, serve_model,
)

__all__ = ["CanaryPolicy", "HTTPSource", "ModelRegistry",
           "PartitionConsolidator", "PipelineHandle", "ServingEngine",
           "ServingFleet", "ServingUnavailable", "SharedSingleton",
           "SharedVariable", "SwapEvent", "SwapInProgress", "SwapResult",
           "json_row_scoring_pipeline", "json_scoring_pipeline",
           "serve_model"]
