"""Pretrained-graph ingestion of the PyTorch port (see
``mmlspark_tpu/importers/__init__.py``): torch checkpoints into the zoo
networks' weights (``torch_import``), and ONNX graphs through a
dependency-free reader and a torch executor (``onnx_import``)."""

from mmlspark_tpu_torch.importers.onnx_import import (
    OnnxApply, import_onnx_model, load_onnx, onnx_summary,
)
from mmlspark_tpu_torch.importers.torch_import import (
    TORCHVISION_RESNET18_SPEC, TORCHVISION_RESNET34_SPEC,
    import_torch_checkpoint, import_torchvision_resnet,
    load_checkpoint_file, load_safetensors_file, load_torch_file,
)

__all__ = [
    "TORCHVISION_RESNET18_SPEC", "TORCHVISION_RESNET34_SPEC",
    "OnnxApply", "import_onnx_model", "import_torch_checkpoint",
    "import_torchvision_resnet", "load_checkpoint_file", "load_onnx",
    "load_safetensors_file", "load_torch_file", "onnx_summary",
]
