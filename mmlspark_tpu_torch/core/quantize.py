"""Serving-precision labels: the part of ``mmlspark_tpu/core/quantize.py``
that the serving engine reads (``PipelineHandle`` labels each model
version with it). The rest of that module — int8 post-training
quantization behind ``TPUModel.quantize`` — is not ported yet
(ROADMAP.md, 'DNN int8 inference')."""

from __future__ import annotations


def stage_precision(stage) -> str:
    """A stage's serving precision label: 'int8' when the stage carries
    quantized weights, else 'f32'."""
    get = getattr(stage, "get", None)
    if callable(get):
        try:
            p = get("precision")
            if p:
                return str(p)
        except Exception:  # noqa: BLE001 — stages without the param
            pass
    return str(getattr(stage, "precision", "f32"))
