"""Pipeline stages: image, utility, data-prep, text, featurizer."""

from mmlspark_tpu_torch.stages.basic import (
    Cacher, CheckpointData, ClassBalancer, ClassBalancerModel, DropColumns,
    Explode, Lambda, RenameColumn, Repartition, SelectColumns,
    TextPreprocessor, Timer, TimerModel, UDFTransformer,
)
from mmlspark_tpu_torch.stages.dataprep import (
    CleanMissingData, CleanMissingDataModel, DataConversion, EnsembleByKey,
    FastVectorAssembler, MultiColumnAdapter, MultiColumnAdapterModel,
    PartitionSample, StandardScaler, StandardScalerModel, SummarizeData,
    ValueIndexer, ValueIndexerModel,
)
from mmlspark_tpu_torch.stages.image import (
    ImageSetAugmenter, ImageTransformer, UnrollImage,
)
from mmlspark_tpu_torch.stages.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.stages.text import (
    CountVectorizer, CountVectorizerModel, HashingTF, IDF, IDFModel, NGram,
    StopWordsRemover, TextFeaturizer, TextFeaturizerModel, Tokenizer,
)

__all__ = [
    "Cacher", "CheckpointData", "ClassBalancer", "ClassBalancerModel",
    "DropColumns", "Explode", "Lambda", "RenameColumn", "Repartition",
    "SelectColumns", "TextPreprocessor", "Timer", "TimerModel",
    "UDFTransformer",
    "CleanMissingData", "CleanMissingDataModel", "DataConversion",
    "EnsembleByKey", "FastVectorAssembler", "MultiColumnAdapter",
    "MultiColumnAdapterModel", "PartitionSample", "StandardScaler",
    "StandardScalerModel", "SummarizeData",
    "ValueIndexer", "ValueIndexerModel",
    "ImageSetAugmenter", "ImageTransformer", "UnrollImage",
    "ImageFeaturizer",
    "CountVectorizer", "CountVectorizerModel", "HashingTF", "IDF",
    "IDFModel", "NGram", "StopWordsRemover", "TextFeaturizer",
    "TextFeaturizerModel", "Tokenizer",
]
