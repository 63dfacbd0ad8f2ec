"""The port's ``TestObject`` factories, one or more for every registered
stage (the registrations of ``tests/test_fuzzing.py`` in the JAX package,
at the same tiny sizes: 24 rows, 3 features, 16 x 16 images).

``register_all()`` fills ``testing.fuzzing.FUZZING_REGISTRY`` once.
Every stage that has a ``device`` param is built with ``device="cpu"``;
``on_device(stage, device)`` moves a built stage, and the stages it
holds (``model``, ``models``, ``stage``, ``baseStage``), to another
device, so the same objects run on the card and are held against the
CPU. An object marked ``device_seeded`` draws its weights on the device
it runs on (``networks.init_weights``: a CUDA generator's stream is not
the CPU's), so its card run has its own values and only its shapes
match the CPU's; the same learner built from a CPU module
(``moduleFactory=mlp_module``) is held to the CPU. ``EXEMPT`` names the
registered stages that have no TestObject, and why; a fitted model is
fuzzed through its estimator.

Nothing here imports the tests: a script on a machine without JAX
reaches the factories through this module.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.core.schema import ImageSchema
from mmlspark_tpu_torch.core.stage import PipelineStage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.testing.fuzzing import (
    FUZZING_REGISTRY, TestObject, register_test_object,
)

# ref: FuzzingTest.scala:26-35 — each exemption with its reason
EXEMPT: Dict[str, str] = {
    # abstract bases / containers (fuzzed through concrete stages)
    "Transformer": "abstract base",
    "Estimator": "abstract base",
    "Model": "abstract base",
    "Pipeline": "container; fuzzed via composed stages",
    "PipelineModel": "container; fuzzed via composed stages",
    # network-dependent stages: fuzzed against live servers in
    # tests/test_torch_serving.py
    "HTTPTransformer": "needs live server (test_torch_serving)",
    "SimpleHTTPTransformer": "needs live server (test_torch_serving)",
    # internal helper stage of TextFeaturizer
    "RenameTo": "internal to TextFeaturizerModel",
}
# fitted models are covered through their estimator's fuzzers
MODEL_EXEMPT_REASON = "Model subclass; fuzzed via its estimator"

# params through which a stage holds other stages
_NESTED = ("model", "models", "stage", "baseStage")

CONV_SPEC = {"type": "convnet", "conv_features": [4],
             "dense_features": [8], "num_classes": 2}


# ---------------------------------------------------------------------------
# shared tiny tables
# ---------------------------------------------------------------------------


def num_table(n: int = 24, seed: int = 0) -> DataTable:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    return DataTable({
        "features": X,
        "label": (X[:, 0] > 0).astype(float),
        "num": X[:, 1],
        "cat": [["a", "b"][i % 2] for i in range(n)],
        "text": ["quick brown fox" if i % 2 else "lazy dog"
                 for i in range(n)],
        "toks": [["quick", "fox"] if i % 2 else ["lazy"]
                 for i in range(n)],
        "lists": [[float(i), float(i + 1)] for i in range(n)],
    })


def img_table(n: int = 4) -> DataTable:
    rng = np.random.default_rng(0)
    rows = [ImageSchema.make_row(
        f"img{i}", rng.integers(0, 255, (16, 16, 3)).astype(np.uint8),
        "RGB") for i in range(n)]
    return DataTable({"image": rows, "label": [float(i % 2)
                                               for i in range(n)]})


def resp_table() -> DataTable:
    from mmlspark_tpu_torch.io.http import HTTPSchema
    return DataTable({"resp": [
        HTTPSchema.response(200, "OK", b'{"a": 1}'),
        HTTPSchema.response(500, "ERR", None)]})


def conv_weights(seed: int = 0) -> Dict[str, Any]:
    """Flax-layout variables of ``CONV_SPEC`` at 16 x 16 x 3, drawn by
    the port's initializer from ``seed``."""
    from mmlspark_tpu_torch.convert import flax_collections
    from mmlspark_tpu_torch.models.networks import build_network, sized_spec
    spec = sized_spec(CONV_SPEC, [16, 16, 3])
    module = build_network(spec, device="cpu", seed=seed)
    values = {k: v.detach().numpy().copy()
              for k, v in module.state_dict().items()}
    return flax_collections(module, values)


def mlp_module():
    """The learner objects' MLP at 3 input features, drawn on the CPU
    from seed 0; the learner moves it to its own device."""
    from mmlspark_tpu_torch.models.networks import build_network
    return build_network({"type": "mlp", "features": [8], "num_classes": 2,
                          "in_features": 3}, device="cpu", seed=0)


def _device_seeded(obj: TestObject) -> TestObject:
    obj.device_seeded = True
    return obj


# module-level functions so pickle-based serialization works
def _double(v):
    return v * 2


def _identity_table(t):
    return t


def _req_from_value(v):
    from mmlspark_tpu_torch.io.http import HTTPSchema
    return HTTPSchema.request("http://example.invalid", "POST",
                              json.dumps({"v": float(v)}).encode())


def _resp_to_code(r):
    return r["statusLine"]["statusCode"]


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------


def has_device_param(stage: PipelineStage) -> bool:
    return any(p.name == "device" for p in type(stage).params())


def on_device(stage: PipelineStage, device: str) -> PipelineStage:
    """Set ``device`` on ``stage`` and on every stage it holds; returns
    ``stage``."""
    if has_device_param(stage):
        stage.set("device", device)
    names = {p.name for p in type(stage).params()}
    for name in _NESTED:
        if name not in names or not stage.is_defined(name):
            continue
        held = stage.get(name)
        for s in held if isinstance(held, (list, tuple)) else [held]:
            if isinstance(s, PipelineStage):
                on_device(s, device)
    return stage


# ---------------------------------------------------------------------------
# registrations
# ---------------------------------------------------------------------------

_REGISTERED = False


def register_all() -> Dict[str, list]:
    """Register every factory (once per process); returns the registry."""
    global _REGISTERED
    if _REGISTERED:
        return FUZZING_REGISTRY
    _REGISTERED = True
    from mmlspark_tpu_torch.automl import (
        AssembleFeatures, ComputeModelStatistics,
        ComputePerInstanceStatistics, DiscreteHyperParam, Featurize,
        FindBestModel, GridSpace, HyperparamBuilder, TrainClassifier,
        TrainRegressor, TuneHyperparameters,
    )
    from mmlspark_tpu_torch.gbdt import TPUBoostClassifier, TPUBoostRegressor
    from mmlspark_tpu_torch.io.http import (
        CustomInputParser, CustomOutputParser, JSONInputParser,
        JSONOutputParser,
    )
    from mmlspark_tpu_torch.io.minibatch import (
        DynamicMiniBatchTransformer, FixedMiniBatchTransformer,
        FlattenBatch, TimeIntervalMiniBatchTransformer,
    )
    from mmlspark_tpu_torch.models.learner import TPULearner
    from mmlspark_tpu_torch.models.linear import (
        TPULinearRegression, TPULogisticRegression,
    )
    from mmlspark_tpu_torch.models.networks import build_network
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.serving.fleet import PartitionConsolidator
    from mmlspark_tpu_torch.stages import (
        Cacher, CheckpointData, ClassBalancer, CleanMissingData,
        CountVectorizer, DataConversion, DropColumns, EnsembleByKey,
        Explode, FastVectorAssembler, HashingTF, IDF, ImageFeaturizer,
        ImageSetAugmenter, ImageTransformer, Lambda, MultiColumnAdapter,
        NGram, PartitionSample, RenameColumn, Repartition, SelectColumns,
        StandardScaler, StopWordsRemover, SummarizeData, TextFeaturizer,
        TextPreprocessor, Timer, Tokenizer, UDFTransformer, UnrollImage,
        ValueIndexer,
    )

    cpu = "cpu"
    reg = register_test_object

    def gbdt(**kw):
        return TPUBoostClassifier(minDataInLeaf=2, device=cpu, **kw)

    def gbdt_reg(**kw):
        return TPUBoostRegressor(minDataInLeaf=2, device=cpu, **kw)

    # utility stages
    reg(lambda: TestObject(Cacher(), transform_table=num_table()))
    reg(lambda: TestObject(DropColumns(cols=["num"]),
                           transform_table=num_table()))
    reg(lambda: TestObject(SelectColumns(cols=["num", "label"]),
                           transform_table=num_table()))
    reg(lambda: TestObject(RenameColumn(inputCol="num", outputCol="n2"),
                           transform_table=num_table()))
    reg(lambda: TestObject(Repartition(n=2), transform_table=num_table()))
    reg(lambda: TestObject(Explode(inputCol="lists", outputCol="item"),
                           transform_table=num_table()))
    reg(lambda: TestObject(Lambda(transformFunc=_identity_table),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        UDFTransformer(inputCol="num", outputCol="num2", udf=_double),
        transform_table=num_table()))
    reg(lambda: TestObject(ClassBalancer(inputCol="cat"),
                           fit_table=num_table()))
    reg(lambda: TestObject(
        TextPreprocessor(inputCol="text", outputCol="text2",
                         map={"quick": "slow"}),
        transform_table=num_table()))
    reg(lambda: TestObject(Timer(stage=ClassBalancer(inputCol="cat")),
                           fit_table=num_table()))
    reg(lambda: TestObject(CheckpointData(), transform_table=num_table()))

    # data prep
    reg(lambda: TestObject(PartitionConsolidator(hostCount=2, hostIndex=0),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        FastVectorAssembler(inputCols=["num", "label"], outputCol="fv"),
        transform_table=num_table()))
    reg(lambda: TestObject(ValueIndexer(inputCol="cat", outputCol="ci"),
                           fit_table=num_table()))
    reg(lambda: TestObject(
        CleanMissingData(inputCols=["num"], outputCols=["numc"]),
        fit_table=num_table()))
    reg(lambda: TestObject(
        StandardScaler(inputCol="features", outputCol="features_std"),
        fit_table=num_table()))
    reg(lambda: TestObject(DataConversion(cols=["num"], convertTo="float"),
                           transform_table=num_table()))
    reg(lambda: TestObject(SummarizeData(), transform_table=num_table()))
    reg(lambda: TestObject(PartitionSample(mode="Head", count=5),
                           transform_table=num_table()))
    reg(lambda: TestObject(EnsembleByKey(keys=["cat"], cols=["num"]),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        MultiColumnAdapter(baseStage=Tokenizer(), inputCols=["text"],
                           outputCols=["text_toks"]),
        fit_table=num_table()))

    # text
    reg(lambda: TestObject(Tokenizer(inputCol="text", outputCol="tk"),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        StopWordsRemover(inputCol="toks", outputCol="ns"),
        transform_table=num_table()))
    reg(lambda: TestObject(NGram(inputCol="toks", outputCol="ng"),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        HashingTF(inputCol="toks", outputCol="tf", numFeatures=16),
        transform_table=num_table()))
    reg(lambda: TestObject(
        CountVectorizer(inputCol="toks", outputCol="cv"),
        fit_table=num_table()))
    reg(lambda: TestObject(IDF(inputCol="features", outputCol="idf"),
                           fit_table=num_table()))
    reg(lambda: TestObject(
        TextFeaturizer(inputCol="text", outputCol="tfeat", numFeatures=32),
        fit_table=num_table()))

    # image
    reg(lambda: TestObject(
        ImageTransformer(inputCol="image", outputCol="image",
                         device=cpu).resize(8, 8),
        transform_table=img_table()))
    reg(lambda: TestObject(UnrollImage(inputCol="image"),
                           transform_table=img_table()))
    reg(lambda: TestObject(ImageSetAugmenter(inputCol="image"),
                           transform_table=img_table()))
    reg(lambda: TestObject(
        ImageFeaturizer(networkSpec=CONV_SPEC, weights=conv_weights(),
                        inputHeight=16, inputWidth=16, cutOutputLayers=1,
                        device=cpu),
        transform_table=img_table(), tol=1e-3))

    # minibatch
    reg(lambda: TestObject(FixedMiniBatchTransformer(batchSize=4),
                           transform_table=num_table()))
    reg(lambda: TestObject(DynamicMiniBatchTransformer(),
                           transform_table=num_table()))
    reg(lambda: TestObject(TimeIntervalMiniBatchTransformer(),
                           transform_table=num_table()))
    reg(lambda: TestObject(
        FlattenBatch(),
        transform_table=FixedMiniBatchTransformer(batchSize=4).transform(
            num_table())))

    # http parsers (no network needed)
    reg(lambda: TestObject(
        JSONInputParser(url="http://example.invalid", inputCol="num",
                        outputCol="req"),
        transform_table=num_table()))
    reg(lambda: TestObject(
        CustomInputParser(inputCol="num", outputCol="req",
                          udf=_req_from_value),
        transform_table=num_table()))
    reg(lambda: TestObject(
        JSONOutputParser(inputCol="resp", outputCol="out"),
        transform_table=resp_table()))
    reg(lambda: TestObject(
        CustomOutputParser(inputCol="resp", outputCol="out",
                           udf=_resp_to_code),
        transform_table=resp_table()))

    # ML estimators
    reg(lambda: TestObject(gbdt(numIterations=3), fit_table=num_table()))
    reg(lambda: TestObject(gbdt_reg(numIterations=3, labelCol="num"),
                           fit_table=num_table()))
    reg(lambda: TestObject(TPULogisticRegression(maxIter=20, device=cpu),
                           fit_table=num_table()))
    reg(lambda: TestObject(
        TPULinearRegression(maxIter=20, labelCol="num", device=cpu),
        fit_table=num_table()))
    reg(lambda: _device_seeded(TestObject(
        TPULearner(networkSpec={"type": "mlp", "features": [8],
                                "num_classes": 2},
                   epochs=1, batchSize=8, computeDtype="float32",
                   checkpointDir="", device=cpu),
        fit_table=num_table(), tol=1e-2)))
    reg(lambda: TestObject(
        TPULearner(moduleFactory=mlp_module, epochs=1, batchSize=8,
                   computeDtype="float32", checkpointDir="", device=cpu),
        fit_table=num_table(), tol=1e-2))
    # a model built outside any estimator (the reference fuzzes TPUModel
    # through TPULearner only; the port adds its own object)
    reg(lambda: TestObject(
        TPUModel.from_module(
            build_network({"type": "mlp", "features": [4], "num_classes": 2,
                           "in_features": 3}, device=cpu, seed=0),
            device=cpu, inputCol="features", outputCol="scores"),
        transform_table=num_table(), tol=1e-5))

    # automl
    reg(lambda: TestObject(Featurize(featureColumns=["num", "cat"]),
                           fit_table=num_table()))
    reg(lambda: TestObject(
        AssembleFeatures(columnsToFeaturize=["num", "cat"]),
        fit_table=num_table()))
    reg(lambda: TestObject(
        TrainClassifier(labelCol="label", featureColumns=["num", "cat"],
                        model=gbdt(numIterations=3), device=cpu),
        fit_table=num_table()))
    reg(lambda: TestObject(
        TrainRegressor(labelCol="num", featureColumns=["features"],
                       model=gbdt_reg(numIterations=3), device=cpu),
        fit_table=num_table()))
    reg(lambda: TestObject(ComputeModelStatistics(
        evaluationMetric="regression", scoresCol="num", labelCol="num"),
        transform_table=num_table()))
    reg(lambda: TestObject(ComputePerInstanceStatistics(
        evaluationMetric="regression", scoresCol="num", labelCol="num"),
        transform_table=num_table()))
    reg(lambda: TestObject(
        TuneHyperparameters(
            models=[gbdt(numIterations=2)],
            paramSpace=GridSpace(
                HyperparamBuilder().add_hyperparam(
                    "numLeaves", DiscreteHyperParam([4])).build()),
            numFolds=2, parallelism=1),
        fit_table=num_table(), skip_serialization=True))
    reg(lambda: TestObject(
        FindBestModel(models=[gbdt(numIterations=2).fit(num_table())]),
        fit_table=num_table(), skip_serialization=True))
    return FUZZING_REGISTRY
