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
through two flash-attention kernels). See ROADMAP.md for what comes next.
"""

from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.device import resolve_device
from mmlspark_tpu_torch.gbdt import (
    BinMapper, Booster, TPUBoostClassificationModel, TPUBoostClassifier,
    TPUBoostRegressionModel, TPUBoostRegressor, train,
)
from mmlspark_tpu_torch.models.learner import TPULearner
from mmlspark_tpu_torch.models.networks import build_network
from mmlspark_tpu_torch.models.tpu_model import TPUModel

__all__ = ["DataTable", "resolve_device", "BinMapper", "Booster", "train",
           "TPUBoostClassifier", "TPUBoostClassificationModel",
           "TPUBoostRegressor", "TPUBoostRegressionModel", "TPUModel",
           "TPULearner", "build_network"]
