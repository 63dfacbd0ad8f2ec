"""GBDT engine of the PyTorch port (see ``mmlspark_tpu/gbdt``)."""

from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.booster import Booster, train
from mmlspark_tpu_torch.gbdt.estimators import (
    TPUBoostClassificationModel, TPUBoostClassifier, TPUBoostRegressionModel,
    TPUBoostRegressor,
)

__all__ = ["BinMapper", "Booster", "train", "TPUBoostClassifier",
           "TPUBoostClassificationModel", "TPUBoostRegressor",
           "TPUBoostRegressionModel"]
