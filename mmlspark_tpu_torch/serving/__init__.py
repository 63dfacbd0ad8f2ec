"""HTTP serving of the port: the engine (``server.py``) and the standard
scorers (``fleet.py``)."""

from mmlspark_tpu_torch.serving.fleet import (
    ServingUnavailable, json_row_scoring_pipeline, json_scoring_pipeline,
)
from mmlspark_tpu_torch.serving.server import (
    HTTPSource, PipelineHandle, ServingEngine, SharedSingleton,
    SharedVariable, serve_model,
)

__all__ = ["HTTPSource", "PipelineHandle", "ServingEngine",
           "ServingUnavailable", "SharedSingleton", "SharedVariable",
           "json_row_scoring_pipeline", "json_scoring_pipeline",
           "serve_model"]
