"""HTTP serving of the port: the engine (``server.py``), the versioned
model lifecycle (``lifecycle.py``), the standard scorers, the fleet
client and partition consolidation (``fleet.py``), and the multi-model
plane: the model zoo (``zoo.py``) and admission control
(``admission.py``), with the variant selector (``variants.py``), the
fleet autoscaler (``autoscale.py``) and the placement plane
(``placement.py``) resolved lazily; the continuous-training control
loop (``controlplane.py``); and the shared-memory ring of the columnar
client (``io/shm.py``), resolved lazily."""

from mmlspark_tpu_torch.serving.admission import (
    AdmissionController, TenantQuota,
)
from mmlspark_tpu_torch.serving.controlplane import (
    ContinuousTrainer, GatePolicy, IngestDriver, PromoteEvent,
    QuarantineEvent, RefitPolicy, RetrainEvent, ShadowEvent,
    TriggerPolicy,
)
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
from mmlspark_tpu_torch.serving.zoo import (
    ModelZoo, ZooEvent, model_key_of,
)

# the placement plane and the SLO-adaptive plane (variant selection,
# fleet autoscaling) resolve on first touch (PEP 562): most clients
# never opt in, and `import mmlspark_tpu_torch.serving` stays cheap
_LAZY_EXPORTS = {
    "PlacementController": "mmlspark_tpu_torch.serving.placement",
    "PlacementEvent": "mmlspark_tpu_torch.serving.placement",
    "VariantSelector": "mmlspark_tpu_torch.serving.variants",
    "VariantEvent": "mmlspark_tpu_torch.serving.variants",
    "FleetAutoscaler": "mmlspark_tpu_torch.serving.autoscale",
    "AutoscaleEvent": "mmlspark_tpu_torch.serving.autoscale",
    # shm pulls the columnar codecs, which a client that never opts in
    # does not need on its import path
    "ShmRing": "mmlspark_tpu_torch.io.shm",
    "shm_available": "mmlspark_tpu_torch.io.shm",
}


def __getattr__(name):
    if name in _LAZY_EXPORTS:
        import importlib
        return getattr(importlib.import_module(_LAZY_EXPORTS[name]), name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = ["AdmissionController", "AutoscaleEvent", "CanaryPolicy",
           "ContinuousTrainer", "FleetAutoscaler", "GatePolicy",
           "HTTPSource", "IngestDriver", "ModelRegistry", "ModelZoo",
           "PartitionConsolidator", "PipelineHandle",
           "PlacementController", "PlacementEvent", "PromoteEvent",
           "QuarantineEvent", "RefitPolicy", "RetrainEvent",
           "ServingEngine", "ServingFleet", "ServingUnavailable",
           "ShadowEvent", "SharedSingleton", "SharedVariable", "ShmRing",
           "SwapEvent", "SwapInProgress", "SwapResult", "TenantQuota",
           "TriggerPolicy", "VariantEvent", "VariantSelector", "ZooEvent",
           "json_row_scoring_pipeline", "json_scoring_pipeline",
           "model_key_of", "serve_model", "shm_available"]
