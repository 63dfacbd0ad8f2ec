"""mmlspark_tpu_torch — the PyTorch / CUDA port of mmlspark_tpu.

A second package beside ``mmlspark_tpu`` (the JAX reference, which it
imports nothing of): the same stages, param names and Booster model
string, running on an NVIDIA GPU through kernels written by hand for
Hopper (``csrc/``, built with ``nvcc`` at first use).

Entry points run on the card unless the caller asks for the CPU with
``device="cpu"``; without a card they raise. Ported so far: the GBDT
path, ``TPUBoostClassifier/Regressor.fit`` -> ``transform`` (dense,
serial, float32 histograms), and DNN inference, ``TPUModel.transform``
over the ``Transformer`` and ``MLP`` of ``build_network`` (attention at
L >= 512 through a flash-attention kernel), and single-card DNN training,
``TPULearner(...).fit(table)`` -> ``TPUModel`` (the attention backward
through two flash-attention kernels). Stages compose into ``Pipeline``
and ``save`` / ``load_stage`` in the JAX package's on-disk format (either
package loads the other's GBDT models), and a fitted model serves over
HTTP: ``serving.serve_model(serving.json_scoring_pipeline(model))`` or
``python -m mmlspark_tpu_torch.cli serve --model M``. The
transfer-learning image path: ``read_images`` / ``read_binary_files``,
``ImageTransformer`` (the op list on the card), the model zoo
(``LocalRepo``, ``ModelDownloader``; the JAX package's flax msgpack
blobs, read without flax), torchvision checkpoint import
(``importers.torch_import``) and ``ImageFeaturizer`` (a truncated zoo
network on the card). A fitted pipeline runs fused on the card:
``fuse(pipeline)`` / ``PipelineModel.fused()`` -> ``FusedPipelineModel``
(``transform``, ``transform_chunked`` over an ``io.ooc.ChunkedTable``),
and serves from raw JSON rows through ``json_scoring_pipeline``. See
ROADMAP.md for what comes next.
"""

from mmlspark_tpu_torch.core.fusion import FusedPipelineModel, fuse
from mmlspark_tpu_torch.core.schema import BinaryFileSchema, ImageSchema
from mmlspark_tpu_torch.core.stage import Pipeline, PipelineModel, load_stage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.downloader import LocalRepo, ModelDownloader
from mmlspark_tpu_torch.gbdt import (
    BinMapper, Booster, TPUBoostClassificationModel, TPUBoostClassifier,
    TPUBoostRegressionModel, TPUBoostRegressor, train,
)
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.image import read_images
from mmlspark_tpu_torch.models.tpu_model import TPUModel
from mmlspark_tpu_torch.stages.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.stages.image import ImageTransformer

__all__ = ["DataTable", "Pipeline", "PipelineModel", "load_stage",
           "resolve_device", "BinMapper", "Booster", "train",
           "TPUBoostClassifier", "TPUBoostClassificationModel",
           "TPUBoostRegressor", "TPUBoostRegressionModel", "TPUModel",
           "TPULearner", "build_network", "ImageSchema", "BinaryFileSchema",
           "read_images", "read_binary_files", "ImageTransformer",
           "ImageFeaturizer", "LocalRepo", "ModelDownloader",
           "FusedPipelineModel", "fuse"]
