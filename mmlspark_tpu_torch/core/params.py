"""Typed parameter DSL for pipeline stages.

The PyTorch port keeps its own copy of ``mmlspark_tpu/core/params.py``:
params keep their names and domains, so a stage's settings carry over
between the two packages.

Analog of the reference's MMLParams layer
(ref: src/core/contracts/src/main/scala/Params.scala:10-227): every stage
declares typed params with docs, defaults, and validation domains; shared
column names come from mixin traits (HasInputCol etc.).

Params are Python descriptors declared as class attributes; values live in
the owning stage's ``_paramMap``/``_defaultMap`` so stages copy and
serialize cheaply.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

_NO_VALUE = object()


class Param:
    """A typed stage parameter with default + optional validation domain.

    ref: Params.scala:60-108 (ParamInfo / untypedParam with default and
    isValid domain).
    """

    # subclasses set this to coerce/validate raw values
    ptype: Optional[type] = None

    def __init__(self, doc: str = "", default: Any = _NO_VALUE,
                 domain: Optional[Callable[[Any], bool]] = None,
                 name: Optional[str] = None,
                 is_complex: bool = False):
        self.name = name  # filled by __set_name__
        self.doc = doc
        self.default = default
        self.domain = domain
        self.is_complex = is_complex

    def __set_name__(self, owner, name):
        if self.name is None:
            self.name = name

    # descriptor protocol ---------------------------------------------------

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get(self)

    def __set__(self, obj, value):
        obj.set(self, value)

    # validation ------------------------------------------------------------

    def coerce(self, value: Any) -> Any:
        if self.ptype is not None and value is not None:
            if self.ptype is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                value = float(value)
            if not isinstance(value, self.ptype):
                raise TypeError(
                    f"param {self.name!r} expects {self.ptype.__name__}, "
                    f"got {type(value).__name__}: {value!r}")
        return value

    def validate(self, value: Any) -> Any:
        value = self.coerce(value)
        if self.domain is not None and value is not None:
            if not self.domain(value):
                raise ValueError(
                    f"value {value!r} out of domain for param {self.name!r}")
        return value

    @property
    def has_default(self) -> bool:
        return self.default is not _NO_VALUE

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class IntParam(Param):
    ptype = int

    def coerce(self, value):
        if isinstance(value, bool):
            raise TypeError(f"param {self.name!r} expects int, got bool")
        import numpy as np
        if isinstance(value, np.integer):
            value = int(value)
        return super().coerce(value)


class FloatParam(Param):
    ptype = float

    def coerce(self, value):
        import numpy as np
        if isinstance(value, (np.floating, np.integer)):
            value = float(value)
        return super().coerce(value)


class BoolParam(Param):
    ptype = bool


class StringParam(Param):
    ptype = str


class ListParam(Param):
    ptype = list

    def coerce(self, value):
        if isinstance(value, tuple):
            value = list(value)
        return super().coerce(value)


class DictParam(Param):
    ptype = dict


class ColParam(StringParam):
    """A parameter naming a table column."""


class EnumParam(StringParam):
    def __init__(self, values: Sequence[str], doc: str = "",
                 default: Any = _NO_VALUE, **kw):
        self.values = list(values)
        super().__init__(doc=doc, default=default,
                         domain=lambda v: v in self.values, **kw)


def range_domain(lo=None, hi=None, lo_inc=True, hi_inc=True):
    """RangeParam analog (ref: Params.scala:70-90)."""
    def check(v):
        if lo is not None and (v < lo or (not lo_inc and v == lo)):
            return False
        if hi is not None and (v > hi or (not hi_inc and v == hi)):
            return False
        return True
    return check


class ComplexParam(Param):
    """A param whose value is not JSON-encodable — models, tables, stages,
    arrays, callables (ref: src/core/serialize/src/main/scala/ComplexParam.scala
    and params/*.scala). Serialized through typed handlers in
    mmlspark_tpu.core.serialize.
    """

    def __init__(self, doc: str = "", default: Any = _NO_VALUE, **kw):
        kw.pop("is_complex", None)
        super().__init__(doc=doc, default=default, is_complex=True, **kw)


class StageParam(ComplexParam):
    """Value is a PipelineStage (ref: serialize/params/EstimatorParam.scala,
    TransformerParam.scala)."""


class TableParam(ComplexParam):
    """Value is a DataTable (ref: serialize/params/DataFrameParam.scala)."""


class ArrayParam(ComplexParam):
    """Value is a numpy array (ref: serialize/params/ByteArrayParam.scala)."""


class UDFParam(ComplexParam):
    """Value is a python callable (ref: serialize/params/UDFParam.scala)."""


class PyTreeParam(ComplexParam):
    """Value is a nested structure of arrays (model weights etc.)."""


# ---------------------------------------------------------------------------
# Shared column mixins (ref: Params.scala:112-227)
# ---------------------------------------------------------------------------


class HasInputCol:
    inputCol = ColParam("The name of the input column", default="input")

    def set_input_col(self, v: str):
        self.set(type(self).inputCol, v); return self

    def get_input_col(self) -> str:
        return self.get(type(self).inputCol)


class HasOutputCol:
    outputCol = ColParam("The name of the output column", default="output")

    def set_output_col(self, v: str):
        self.set(type(self).outputCol, v); return self

    def get_output_col(self) -> str:
        return self.get(type(self).outputCol)


class HasInputCols:
    inputCols = ListParam("The names of the input columns", default=None)

    def set_input_cols(self, v: Sequence[str]):
        self.set(type(self).inputCols, list(v)); return self

    def get_input_cols(self) -> List[str]:
        return self.get(type(self).inputCols)


class HasOutputCols:
    outputCols = ListParam("The names of the output columns", default=None)

    def set_output_cols(self, v: Sequence[str]):
        self.set(type(self).outputCols, list(v)); return self

    def get_output_cols(self) -> List[str]:
        return self.get(type(self).outputCols)


class HasLabelCol:
    labelCol = ColParam("The name of the label column", default="label")

    def set_label_col(self, v: str):
        self.set(type(self).labelCol, v); return self

    def get_label_col(self) -> str:
        return self.get(type(self).labelCol)


class HasFeaturesCol:
    featuresCol = ColParam("The name of the features column", default="features")

    def set_features_col(self, v: str):
        self.set(type(self).featuresCol, v); return self

    def get_features_col(self) -> str:
        return self.get(type(self).featuresCol)


class HasPredictionCol:
    predictionCol = ColParam("The name of the prediction column",
                             default="prediction")

    def set_prediction_col(self, v: str):
        self.set(type(self).predictionCol, v); return self

    def get_prediction_col(self) -> str:
        return self.get(type(self).predictionCol)
