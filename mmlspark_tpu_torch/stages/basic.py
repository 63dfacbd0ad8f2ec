"""The pipeline-stages utility set: the port's copy of
``mmlspark_tpu/stages/basic.py``, so far holding only ``Lambda``, the
stage both serving scorers wrap. The other stages of the reference's
module (Cacher, ClassBalancer, DropColumns, Explode, RenameColumn,
Repartition, SelectColumns, TextPreprocessor, Timer, UDFTransformer)
are ROADMAP.md's 'Featurization and AutoML stages'.
"""

from __future__ import annotations

from typing import Callable

from mmlspark_tpu_torch.core.params import UDFParam
from mmlspark_tpu_torch.core.schema import Schema
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable


class Lambda(Transformer):
    """Arbitrary table->table function as a stage
    (ref: Lambda.scala:21)."""

    transformFunc = UDFParam("table -> table function", default=None)
    transformSchemaFunc = UDFParam("schema -> schema function", default=None)

    @staticmethod
    def apply(fn: Callable[[DataTable], DataTable]) -> "Lambda":
        return Lambda(transformFunc=fn)

    def transform(self, table: DataTable) -> DataTable:
        fn = self.get("transformFunc")
        if fn is None:
            raise ValueError("transformFunc is not set")
        return fn(table)

    def transform_schema(self, schema: Schema) -> Schema:
        fn = self.get_or_none("transformSchemaFunc")
        return fn(schema) if fn is not None else schema
