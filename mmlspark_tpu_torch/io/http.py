"""HTTP-on-tables: typed HTTP schema, client transformers, parsers — the
port's copy of ``mmlspark_tpu/io/http.py``.

Analog of the reference's io/http client layer
(ref: src/io/http/src/main/scala/HTTPSchema.scala:25-216,
HTTPTransformer.scala:80-130, HTTPClients.scala:47-98, Clients.scala:66-116,
SimpleHTTPTransformer.scala:60-150, Parsers.scala:30-158): the full HTTP
request/response protocol is a struct column; HTTPTransformer runs a
bounded-concurrency client pool over the request column (AsyncClient
analog — here a thread pool, since urllib releases the GIL in socket IO);
SimpleHTTPTransformer composes input parser → minibatch → client →
error-split → output parser → flatten. ``PowerBIWriter`` posts a
table's rows in JSON batches to a push endpoint.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.core.params import (
    BoolParam, ColParam, DictParam, EnumParam, FloatParam, HasInputCol,
    HasOutputCol, IntParam, ListParam, StageParam, StringParam, UDFParam,
)
from mmlspark_tpu_torch.core.schema import Field, Schema, STRUCT
from mmlspark_tpu_torch.core.stage import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.io.minibatch import (
    FlattenBatch, HasMiniBatcher,
)
from mmlspark_tpu_torch.utils.resilience import Deadline, RetryPolicy

log = get_logger("io.http")


# ---------------------------------------------------------------------------
# HTTP protocol as column structs (ref: HTTPSchema.scala:25-216)
# ---------------------------------------------------------------------------


class HTTPSchema:
    """Request/response struct constructors + schema Fields."""

    @staticmethod
    def request(url: str, method: str = "POST",
                entity: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        return {"requestLine": {"method": method, "uri": url},
                "headers": dict(headers or {}),
                "entity": entity}

    @staticmethod
    def response(status_code: int, reason: str, entity: Optional[bytes],
                 headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        return {"statusLine": {"statusCode": int(status_code),
                               "reasonPhrase": reason},
                "headers": dict(headers or {}),
                "entity": entity}

    @staticmethod
    def request_field(name: str) -> Field:
        return Field(name, STRUCT, {"struct_kind": "http_request"})

    @staticmethod
    def response_field(name: str) -> Field:
        return Field(name, STRUCT, {"struct_kind": "http_response"})

    @staticmethod
    def entity_to_string(resp: Optional[Dict[str, Any]]) -> Optional[str]:
        if resp is None or resp.get("entity") is None:
            return None
        e = resp["entity"]
        return e.decode("utf-8") if isinstance(e, (bytes, bytearray)) \
            else str(e)

    @staticmethod
    def string_to_request(url_col_value: str, method: str = "GET"
                          ) -> Dict[str, Any]:
        return HTTPSchema.request(url_col_value, method=method, entity=None)


# ---------------------------------------------------------------------------
# client handlers (ref: HTTPClients.scala:47-98 advanced/basic handlers)
# ---------------------------------------------------------------------------


def send_request(req: Dict[str, Any], timeout: float) -> Dict[str, Any]:
    line = req["requestLine"]
    data = req.get("entity")
    if isinstance(data, str):
        data = data.encode("utf-8")
    r = urllib.request.Request(
        line["uri"], data=data, method=line.get("method", "POST"),
        headers=req.get("headers") or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return HTTPSchema.response(resp.status, resp.reason,
                                       resp.read(), dict(resp.headers))
    except urllib.error.HTTPError as e:
        return HTTPSchema.response(e.code, str(e.reason),
                                   e.read() if e.fp else None)
    except Exception as e:  # noqa: BLE001 — network errors become rows
        return HTTPSchema.response(0, f"{type(e).__name__}: {e}", None)


def retryable_response(resp: Optional[Dict[str, Any]]) -> bool:
    """Only 429, 5xx, and connection errors (statusCode 0) may burn the
    backoff budget; other 4xx/3xx are deterministic and fail fast."""
    if resp is None:
        return False
    code = resp["statusLine"]["statusCode"]
    return code == 0 or code == 429 or code >= 500


def advanced_handler(req: Dict[str, Any], timeout: float, retries: List[int],
                     deadline: Optional["Deadline"] = None) -> Dict[str, Any]:
    """Retry-with-backoff on 429/5xx/connection errors
    (ref: HTTPClients.scala:47 HandlingUtils.advancedHandling).

    ``retries`` is the backoff schedule in MILLISECONDS; each gap gets
    full jitter (delay ~ U[0, entry]) via the unified RetryPolicy so
    synchronized client retries decorrelate. Non-retryable client errors
    (4xx bar 429) return immediately without sleeping. ``deadline``
    optionally caps the whole call (attempts + backoffs)."""
    policy = RetryPolicy(schedule=[ms / 1000.0 for ms in retries],
                         name="io.http")
    return policy.call(lambda: send_request(req, timeout),
                       retry_result=retryable_response,
                       deadline=deadline)


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Request column -> response column through a bounded-concurrency
    client pool (ref: HTTPTransformer.scala:80-130, Clients.scala:102
    AsyncClient buffered futures)."""

    concurrency = IntParam("in-flight requests per host", default=1)
    timeout = FloatParam("per-request timeout (s)", default=60.0)
    maxRetries = ListParam("backoff schedule in ms",
                           default=[100, 500, 1000])
    handlingStrategy = EnumParam(["basic", "advanced"],
                                 "error handling", default="advanced")

    def transform(self, table: DataTable) -> DataTable:
        reqs = table[self.get_input_col()]
        timeout = self.get("timeout")
        retries = self.get("maxRetries")
        advanced = self.get("handlingStrategy") == "advanced"

        def run(req):
            if req is None:
                return None
            if advanced:
                return advanced_handler(req, timeout, retries)
            return send_request(req, timeout)

        conc = max(1, self.get("concurrency"))
        if conc == 1:
            out = [run(r) for r in reqs]
        else:
            with ThreadPoolExecutor(conc) as pool:
                out = list(pool.map(run, reqs))
        return table.with_column(
            self.get_output_col(), out,
            HTTPSchema.response_field(self.get_output_col()))

    def transform_schema(self, schema: Schema) -> Schema:
        schema.require(self.get_input_col())
        return schema.add_or_replace(
            HTTPSchema.response_field(self.get_output_col()))


# ---------------------------------------------------------------------------
# parsers (ref: Parsers.scala:30-158)
# ---------------------------------------------------------------------------


class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """Row value -> JSON POST request (ref: Parsers.scala:74)."""

    url = StringParam("target url", default="")
    method = StringParam("HTTP method", default="POST")
    headers = DictParam("extra headers", default=None)

    def transform(self, table: DataTable) -> DataTable:
        headers = {"Content-Type": "application/json",
                   **(self.get("headers") or {})}
        out = []
        for v in table[self.get_input_col()]:
            body = json.dumps(_jsonable(v)).encode("utf-8")
            out.append(HTTPSchema.request(self.get("url"),
                                          self.get("method"), body,
                                          headers))
        return table.with_column(
            self.get_output_col(), out,
            HTTPSchema.request_field(self.get_output_col()))

    def transform_schema(self, schema: Schema) -> Schema:
        return schema.add_or_replace(
            HTTPSchema.request_field(self.get_output_col()))


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """udf(value) -> request struct (ref: Parsers.scala:30)."""

    udf = UDFParam("value -> request dict", default=None)

    def transform(self, table: DataTable) -> DataTable:
        fn = self.get("udf")
        out = [fn(v) for v in table[self.get_input_col()]]
        return table.with_column(
            self.get_output_col(), out,
            HTTPSchema.request_field(self.get_output_col()))


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """Response entity -> parsed JSON (ref: Parsers.scala:129)."""

    dataType = DictParam("expected schema (informational)", default=None)

    def transform(self, table: DataTable) -> DataTable:
        out = []
        for resp in table[self.get_input_col()]:
            s = HTTPSchema.entity_to_string(resp)
            try:
                out.append(json.loads(s) if s else None)
            except json.JSONDecodeError:
                out.append(None)
        return table.with_column(self.get_output_col(), out)


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    """udf(response) -> value (ref: Parsers.scala:158)."""

    udf = UDFParam("response dict -> value", default=None)

    def transform(self, table: DataTable) -> DataTable:
        fn = self.get("udf")
        out = [fn(r) for r in table[self.get_input_col()]]
        return table.with_column(self.get_output_col(), out)


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# SimpleHTTPTransformer (ref: SimpleHTTPTransformer.scala:60-150)
# ---------------------------------------------------------------------------


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol,
                            HasMiniBatcher):
    """inputParser → (minibatch) → HTTPTransformer → error split →
    outputParser → flatten."""

    url = StringParam("target url", default="")
    inputParser = StageParam("custom input parser stage", default=None)
    outputParser = StageParam("custom output parser stage", default=None)
    errorCol = ColParam("column collecting failed responses",
                        default="HTTPTransformer_errors")
    concurrency = IntParam("client concurrency", default=1)
    timeout = FloatParam("request timeout (s)", default=60.0)
    flattenOutputBatches = BoolParam("flatten after batched calls",
                                     default=True)

    def transform(self, table: DataTable) -> DataTable:
        in_col = self.get_input_col()
        out_col = self.get_output_col()
        req_col = f"_{self.uid}_request"
        resp_col = f"_{self.uid}_response"

        batcher = self.get_mini_batcher()
        work = table
        if batcher is not None:
            work = batcher.transform(work)

        parser = self.get_or_none("inputParser") or JSONInputParser(
            url=self.get("url"))
        parser = parser.copy()
        parser.set("inputCol", in_col).set("outputCol", req_col)
        work = parser.transform(work)

        client = HTTPTransformer(
            inputCol=req_col, outputCol=resp_col,
            concurrency=self.get("concurrency"),
            timeout=self.get("timeout"))
        work = client.transform(work)

        # error split (ref: SimpleHTTPTransformer.scala:104 ErrorUtils)
        errors = []
        for resp in work[resp_col]:
            ok = resp is not None and \
                200 <= resp["statusLine"]["statusCode"] < 300
            errors.append(None if ok else resp)
        work = work.with_column(self.get("errorCol"), errors)

        out_parser = self.get_or_none("outputParser") or JSONOutputParser()
        out_parser = out_parser.copy()
        out_parser.set("inputCol", resp_col).set("outputCol", out_col)
        work = out_parser.transform(work)
        work = work.drop(req_col, resp_col)

        if batcher is not None and self.get("flattenOutputBatches"):
            work = FlattenBatch().transform(work)
        return work

    def transform_schema(self, schema: Schema) -> Schema:
        from mmlspark_tpu_torch.core.schema import OBJECT
        return (schema
                .add_or_replace(Field(self.get_output_col(), OBJECT))
                .add_or_replace(Field(self.get("errorCol"), OBJECT)))


class PowerBIWriter:
    """Batch/streaming row POST to a PowerBI-style push endpoint
    (ref: src/io/powerbi/src/main/scala/PowerBIWriter.scala:25)."""

    @staticmethod
    def write(table: DataTable, url: str, batch_size: int = 100,
              concurrency: int = 1, timeout: float = 30.0) -> List[int]:
        """POST rows in JSON batches; returns status codes per batch."""
        rows = [_jsonable(r) for r in table.to_rows()]
        batches = [rows[i:i + batch_size]
                   for i in range(0, len(rows), batch_size)]

        def post(batch):
            req = HTTPSchema.request(
                url, "POST", json.dumps(batch).encode("utf-8"),
                {"Content-Type": "application/json"})
            resp = advanced_handler(req, timeout, [100, 500, 1000])
            return resp["statusLine"]["statusCode"]

        if concurrency <= 1:
            return [post(b) for b in batches]
        with ThreadPoolExecutor(concurrency) as pool:
            return list(pool.map(post, batches))
