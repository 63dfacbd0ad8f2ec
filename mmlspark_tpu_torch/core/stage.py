"""PipelineStage / Transformer / Estimator / Pipeline.

The port's own copy of the stage contract of ``mmlspark_tpu/core/stage.py``:
every component is a Transformer (``.transform(table)``) or an Estimator
(``.fit(table) -> Model``), with typed params, composed through
``Pipeline``. Stages auto-register by class name (``__init_subclass__``)
for load-time resolution; ``save``/``load`` go through
``core/serialize.py`` in the JAX package's on-disk format.

``Pipeline.fit`` and ``PipelineModel.transform`` run stage after stage
on the host and drop, between stages, the columns no later stage reads:
the liveness pass of ``core/fusion.py``, fed by the stages'
``reads_columns`` / ``writes_columns`` / ``removes_columns``. A stage
that declares nothing (a user ``Lambda``) disables the pruning across
itself, so pruning changes no output. ``PipelineModel.fused()`` compiles
the fitted stages into fused device segments (``core/fusion.py``).
"""

from __future__ import annotations

import uuid as _uuid
from typing import Any, Dict, List, Optional, Sequence, Type

from mmlspark_tpu_torch.core.params import ComplexParam, Param, _NO_VALUE
from mmlspark_tpu_torch.core.schema import Schema
from mmlspark_tpu_torch.core.table import DataTable

# global registry: class name -> class
STAGE_REGISTRY: Dict[str, Type["PipelineStage"]] = {}


def registered_stages() -> Dict[str, Type["PipelineStage"]]:
    return dict(STAGE_REGISTRY)


class PipelineStage:
    """Base for all stages: typed params, uid, copy."""

    def __init__(self, **kwargs):
        self.uid = f"{type(self).__name__}_{_uuid.uuid4().hex[:12]}"
        self._paramMap: Dict[str, Any] = {}
        self._post_init()
        for k, v in kwargs.items():
            p = self.param(k)
            self.set(p, v)

    def _post_init(self) -> None:
        """Initialize non-param runtime state (cached models). Called by
        __init__ AND by load_stage/copy, so subclasses must put transient
        attributes here, not in __init__."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        STAGE_REGISTRY[cls.__name__] = cls

    # -- param machinery ---------------------------------------------------

    @classmethod
    def _param_map_cls(cls) -> Dict[str, Param]:
        """name -> Param for this class, cached per-class."""
        cached = cls.__dict__.get("_params_cache")
        if cached is not None:
            return cached
        seen: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    seen[v.name or k] = v
        cls._params_cache = seen
        return seen

    @classmethod
    def params(cls) -> List[Param]:
        """All Param descriptors declared on the class and its bases."""
        return list(cls._param_map_cls().values())

    @classmethod
    def param(cls, name: str) -> Param:
        p = cls._param_map_cls().get(name)
        if p is None:
            raise KeyError(f"{cls.__name__} has no param {name!r}")
        return p

    def set(self, param, value) -> "PipelineStage":
        if isinstance(param, str):
            param = self.param(param)
        self._paramMap[param.name] = param.validate(value)
        self._param_epoch = getattr(self, "_param_epoch", 0) + 1
        self._on_param_change(param.name)
        return self

    def _on_param_change(self, name: str) -> None:
        """Hook for subclasses to invalidate derived/runtime state when a
        param changes."""

    def get(self, param) -> Any:
        if isinstance(param, str):
            param = self.param(param)
        if param.name in self._paramMap:
            return self._paramMap[param.name]
        if param.has_default:
            return param.default
        raise KeyError(
            f"param {param.name!r} of {type(self).__name__} is not set "
            f"and has no default")

    def get_or_none(self, param) -> Any:
        try:
            return self.get(param)
        except KeyError:
            return None

    def is_set(self, param) -> bool:
        if isinstance(param, str):
            param = self.param(param)
        return param.name in self._paramMap

    def is_defined(self, param) -> bool:
        if isinstance(param, str):
            param = self.param(param)
        return param.name in self._paramMap or param.has_default

    def clear(self, param) -> "PipelineStage":
        """Unset ``param`` (back to its default); bumps the param epoch
        that keys the fusion planner's cached consts, as ``set`` does."""
        if isinstance(param, str):
            param = self.param(param)
        self._paramMap.pop(param.name, None)
        self._param_epoch = getattr(self, "_param_epoch", 0) + 1
        return self

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "PipelineStage":
        other = type(self).__new__(type(self))
        other.__dict__.update(
            {k: v for k, v in self.__dict__.items() if k != "_paramMap"})
        other._post_init()
        other._paramMap = dict(self._paramMap)
        other.uid = self.uid
        if extra:
            for k, v in extra.items():
                other.set(k, v)
        return other

    def explain_params(self) -> str:
        lines = []
        for p in type(self).params():
            cur = self._paramMap.get(p.name, _NO_VALUE)
            bits = [f"{p.name}: {p.doc}"]
            if p.has_default:
                bits.append(f"(default: {p.default!r})")
            if cur is not _NO_VALUE:
                bits.append(f"(current: {cur!r})")
            lines.append(" ".join(bits))
        return "\n".join(lines)

    # -- persistence -------------------------------------------------------

    def save(self, path: str, overwrite: bool = True) -> None:
        from mmlspark_tpu_torch.core import serialize
        serialize.save_stage(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        from mmlspark_tpu_torch.core import serialize
        stage = serialize.load_stage(path)
        if cls is not PipelineStage and not isinstance(stage, cls):
            raise TypeError(
                f"loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    # -- column-flow declaration (core/fusion.py liveness pass) ------------
    # Stages that know exactly which columns they consume/produce/remove
    # override these; ``None`` means "unknown" and disables pruning
    # across the stage (the conservative default — a UDF/Lambda may
    # touch anything). For Estimators, reads must cover everything
    # fit() consumes AND the fitted model's transform inputs; writes
    # are the fitted model's outputs. ``removes`` is always concrete.

    def reads_columns(self, schema: Schema) -> Optional[List[str]]:
        return None

    def writes_columns(self, schema: Schema) -> Optional[List[str]]:
        return None

    def removes_columns(self, schema: Schema) -> List[str]:
        return []

    def __repr__(self):
        set_params = ", ".join(
            f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
            if not isinstance(v, (DataTable,)))
        return f"{type(self).__name__}({set_params})"


def load_stage(path: str) -> PipelineStage:
    from mmlspark_tpu_torch.core import serialize
    return serialize.load_stage(path)


class Transformer(PipelineStage):
    """A table -> table stage."""

    def transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError

    def transform_schema(self, schema: Schema) -> Schema:
        """Validate/propagate the schema without touching data."""
        return schema

    def __call__(self, table: DataTable) -> DataTable:
        return self.transform(table)


class Estimator(PipelineStage):
    """A table -> Model stage."""

    def fit(self, table: DataTable) -> "Model":
        raise NotImplementedError

    def transform_schema(self, schema: Schema) -> Schema:
        return schema


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""


class Pipeline(Estimator):
    """Chain of stages; fit() runs estimators in sequence feeding each the
    output of the previous fitted prefix (SparkML Pipeline semantics)."""

    stages = ComplexParam("The stages of the pipeline", default=None)

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set_stages(stages)

    def set_stages(self, stages: Sequence[PipelineStage]) -> "Pipeline":
        self.set("stages", list(stages))
        return self

    def get_stages(self) -> List[PipelineStage]:
        return self.get("stages") or []

    def fit(self, table: DataTable) -> "PipelineModel":
        # the intermediate tables threaded through fit only feed LATER
        # stages (final_needed={}), so a wide hashed block or raw text
        # column is dropped the moment no remaining stage reads it
        from mmlspark_tpu_torch.core.fusion import column_liveness, prune_table
        fitted: List[Transformer] = []
        cur = table
        stages = self.get_stages()
        needed = column_liveness(stages, table.schema, final_needed=set())
        for i, stage in enumerate(stages):
            last = i == len(stages) - 1
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if not last:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if not last:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage!r} is not Transformer/Estimator")
            if not last:
                cur = prune_table(cur, needed[i + 1])
        return PipelineModel(stages=fitted)

    def transform_schema(self, schema: Schema) -> Schema:
        for stage in self.get_stages():
            schema = stage.transform_schema(schema)
        return schema


class PipelineModel(Model):
    stages = ComplexParam("The fitted stages of the pipeline", default=None)

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set("stages", list(stages))

    def get_stages(self) -> List[Transformer]:
        return self.get("stages") or []

    def transform(self, table: DataTable) -> DataTable:
        """Stage-at-a-time host execution; an intermediate column nothing
        downstream reads is dropped as soon as its last reader ran. A
        ``ChunkedTable`` maps lazily, chunk by chunk (the fused chunked
        executor is ``FusedPipelineModel.transform_chunked``)."""
        if not isinstance(table, DataTable):
            from mmlspark_tpu_torch.io.ooc import ChunkedTable
            if isinstance(table, ChunkedTable):
                return table.map(self.transform,
                                 label=f"{table.label}|pipeline")
        from mmlspark_tpu_torch.core.fusion import column_liveness, prune_table
        stages = self.get_stages()
        # single-entry liveness cache: the walk is constant for a fixed
        # (schema, stage epochs) pair, and per-batch callers (serving
        # micro-batches, CV folds) transform the same shape repeatedly
        key = (tuple((f.name, f.tag) for f in table.schema),
               tuple((s.uid, getattr(s, "_param_epoch", 0))
                     for s in stages))
        cached = getattr(self, "_liveness_cache", None)
        if cached is not None and cached[0] == key:
            needed = cached[1]
        else:
            needed = column_liveness(stages, table.schema)
            self._liveness_cache = (key, needed)
        for i, stage in enumerate(stages):
            table = stage.transform(table)
            if i < len(stages) - 1:
                table = prune_table(table, needed[i + 1])
        return table

    def fused(self, batch_size: int = 256, device=None):
        """Compile this fitted pipeline for fused execution on ``device``
        (None = the card): maximal runs of device-capable stages become
        fused segments with device-resident constants
        (``core/fusion.py``). Returns a ``FusedPipelineModel`` with the
        same ``transform`` and the serving bucket discipline."""
        from mmlspark_tpu_torch.core.fusion import FusedPipelineModel
        return FusedPipelineModel(self.get_stages(), batch_size=batch_size,
                                  device=device)

    def transform_schema(self, schema: Schema) -> Schema:
        for stage in self.get_stages():
            schema = stage.transform_schema(schema)
        return schema
