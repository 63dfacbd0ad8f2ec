"""AutoML convenience tier of the PyTorch port (the JAX package's
``mmlspark_tpu/automl`` exports).

Parity with the reference's L5 layer (ref: SURVEY.md §2 "L5 AutoML"):
Featurize/AssembleFeatures, TrainClassifier/TrainRegressor,
ComputeModelStatistics/ComputePerInstanceStatistics,
TuneHyperparameters + param spaces, FindBestModel.
"""

from mmlspark_tpu_torch.automl.featurize import AssembleFeatures, Featurize
from mmlspark_tpu_torch.automl.train import (
    TrainClassifier, TrainRegressor,
    TrainedClassifierModel, TrainedRegressorModel,
)
from mmlspark_tpu_torch.automl.statistics import (
    ComputeModelStatistics, ComputePerInstanceStatistics,
)
from mmlspark_tpu_torch.automl.tuning import (
    DiscreteHyperParam, FindBestModel, GridSpace, HyperparamBuilder,
    RandomSpace, RangeHyperParam, TuneHyperparameters,
)

__all__ = [
    "AssembleFeatures", "Featurize",
    "TrainClassifier", "TrainRegressor",
    "TrainedClassifierModel", "TrainedRegressorModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics",
    "TuneHyperparameters", "FindBestModel",
    "GridSpace", "RandomSpace", "HyperparamBuilder",
    "DiscreteHyperParam", "RangeHyperParam",
]
