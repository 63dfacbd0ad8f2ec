"""Model zoo of the PyTorch port: sha256-verified schemas, repos,
downloader (see ``mmlspark_tpu/downloader.py``).

Analog of the reference's downloader component
(ref: src/downloader/src/main/scala/ModelDownloader.scala:37-209,
Schema.scala:54): a repo is a directory holding an ``index.json`` of
model schemas plus one weight blob per model; every fetch verifies the
blob's sha256 against the schema before returning, and fetches from a
repo retry with backoff (ref: FaultToleranceUtils
ModelDownloader.scala:37-50).

The on-disk format is the JAX package's: weights are flax msgpack bytes
(``flax.serialization.to_bytes`` of the flax-layout variables tree,
read and written here by ``core/flax_msgpack.py``, without flax) next to
the JSON network spec. A repo either package publishes loads in the
other. ``load_variables`` returns that tree (``params``, and
``batch_stats`` where the network has BatchNorm) as numpy arrays, after
checking it against the port module's parameter names and shapes
(``convert.check_flax_variables``); ``convert.module_from_flax`` or
``ImageFeaturizer`` turns it into a torch module (the JAX package's
``build_module``, a flax module to init, has no counterpart here).

``HTTPRepo`` needs the filesystem registry (``utils/filesystem.py``),
which is not ported yet: it raises ``NotImplementedError`` naming its
ROADMAP.md item.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterator, List, Optional

from mmlspark_tpu_torch import convert
from mmlspark_tpu_torch.core import flax_msgpack
from mmlspark_tpu_torch.core.logging_utils import get_logger
from mmlspark_tpu_torch.io.binary import FILESYSTEM_ITEM
from mmlspark_tpu_torch.utils.file_utils import sha256_file

log = get_logger("downloader")

DEFAULT_CACHE = os.path.expanduser("~/.mmlspark_tpu/models")


class ModelSchema:
    """Schema of a zoo model (ref: downloader Schema.scala:54-100)."""

    def __init__(self, name: str, dataset: str = "", model_type: str = "",
                 uri: str = "", sha256: str = "", size: int = 0,
                 input_shape: Optional[List[int]] = None,
                 num_layers: int = 0,
                 layer_names: Optional[List[str]] = None,
                 network_spec: Optional[Dict[str, Any]] = None):
        self.name = name
        self.dataset = dataset
        self.model_type = model_type
        self.uri = uri
        self.sha256 = sha256
        self.size = int(size)
        self.input_shape = list(input_shape or [])
        self.num_layers = int(num_layers)
        self.layer_names = list(layer_names or [])
        self.network_spec = dict(network_spec or {})

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "dataset": self.dataset,
                "model_type": self.model_type, "uri": self.uri,
                "sha256": self.sha256, "size": self.size,
                "input_shape": self.input_shape,
                "num_layers": self.num_layers,
                "layer_names": self.layer_names,
                "network_spec": self.network_spec}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ModelSchema":
        return ModelSchema(**d)

    def __repr__(self):
        return f"ModelSchema({self.name!r}, dataset={self.dataset!r})"


def retry_with_backoff(fn, times: int = 3, base_delay: float = 0.5,
                       no_retry: tuple = ()):
    """ref: FaultToleranceUtils.retryWithTimeout
    (ModelDownloader.scala:37-50). Exception types in ``no_retry``
    re-raise immediately — deterministic failures must not burn the
    backoff budget. A shim over ``utils.resilience.RetryPolicy``
    (exponential backoff + full jitter)."""
    from mmlspark_tpu_torch.utils.resilience import RetryPolicy
    if not isinstance(no_retry, tuple):      # bare class, like `except`
        no_retry = (no_retry,)
    return RetryPolicy(max_attempts=times, base_delay=base_delay,
                       no_retry=no_retry, name="downloader").call(fn)


class LocalRepo:
    """Directory-backed model repo (ref: HDFSRepo Schema analog —
    ModelDownloader.scala:54-123): ``index.json`` + ``<name>.msgpack``."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _index_path(self) -> str:
        return os.path.join(self.path, "index.json")

    def _load_index(self) -> Dict[str, Dict[str, Any]]:
        if not os.path.exists(self._index_path()):
            return {}
        with open(self._index_path()) as f:
            return json.load(f)

    def list_schemas(self) -> Iterator[ModelSchema]:
        for d in self._load_index().values():
            yield ModelSchema.from_json(d)

    def get_schema(self, name: str) -> ModelSchema:
        idx = self._load_index()
        if name not in idx:
            raise KeyError(
                f"model {name!r} not in repo {self.path}; "
                f"have {sorted(idx)}")
        return ModelSchema.from_json(idx[name])

    def blob_path(self, schema: ModelSchema) -> str:
        return os.path.join(self.path, f"{schema.name}.msgpack")

    def read_blob(self, schema: ModelSchema, verify: bool = True) -> bytes:
        path = self.blob_path(schema)
        if verify and sha256_file(path) != schema.sha256:
            raise IOError(
                f"sha256 mismatch for {schema.name}: file {path} corrupt "
                f"(ref behavior: ModelDownloader verifies hash on fetch)")
        with open(path, "rb") as f:
            return f.read()

    def publish(self, name: str, network_spec: Dict[str, Any],
                variables: Any = None, dataset: str = "",
                model_type: str = "",
                input_shape: Optional[List[int]] = None,
                layer_names: Optional[List[str]] = None,
                blob: Optional[bytes] = None) -> ModelSchema:
        """Add a model to the repo (the zoo-maintainer path). Pass either
        a flax-layout ``variables`` tree (numpy arrays or CPU tensors) or
        pre-serialized ``blob`` bytes."""
        blob_path = os.path.join(self.path, f"{name}.msgpack")
        blob, schema = _blob_and_schema(
            name, network_spec, variables, blob, f"file://{blob_path}",
            dataset, model_type, input_shape, layer_names)
        with open(blob_path, "wb") as f:
            f.write(blob)
        idx = self._load_index()
        idx[name] = schema.to_json()
        with open(self._index_path(), "w") as f:
            json.dump(idx, f, indent=1)
        return schema


def _blob_and_schema(name, network_spec, variables, blob, uri,
                     dataset, model_type, input_shape, layer_names):
    """Serialize the variables when no blob is given, hash, and build the
    ModelSchema."""
    if blob is None:
        blob = flax_msgpack.packb(variables)
    schema = ModelSchema(
        name=name, dataset=dataset, model_type=model_type,
        uri=uri, sha256=hashlib.sha256(blob).hexdigest(),
        size=len(blob), input_shape=input_shape,
        layer_names=layer_names, network_spec=network_spec)
    return blob, schema


class HTTPRepo:
    """HTTP(S)-backed model repo of the JAX package: not ported yet."""

    def __init__(self, base_url: str, retries: int = 3):
        raise NotImplementedError(
            "HTTPRepo reads through the filesystem registry "
            "(utils/filesystem.py), which is not ported yet: ROADMAP.md, "
            f"'{FILESYSTEM_ITEM}'")


class ModelDownloader:
    """Fetch models from a repo into a local cache, verifying hashes
    (ref: ModelDownloader.scala:209-280 — downloadModel/downloadByName,
    local caching, retry)."""

    def __init__(self, local_path: str = DEFAULT_CACHE,
                 repo: Optional[LocalRepo] = None):
        self.local = LocalRepo(local_path)
        self.repo = repo

    def list_models(self) -> List[ModelSchema]:
        source = self.repo if self.repo is not None else self.local
        return list(source.list_schemas())

    def download_by_name(self, name: str) -> ModelSchema:
        # cached already?
        try:
            schema = self.local.get_schema(name)
            self.local.read_blob(schema)  # verifies hash
            return schema
        except (KeyError, IOError, FileNotFoundError):
            pass
        if self.repo is None:
            raise KeyError(
                f"model {name!r} not cached and no remote repo configured")
        schema = self.repo.get_schema(name)
        # retry here unless the repo declares it retries internally
        if getattr(self.repo, "handles_retries", False):
            blob = self.repo.read_blob(schema)
        else:
            blob = retry_with_backoff(lambda: self.repo.read_blob(schema))
        return self.local.publish(
            name, schema.network_spec, blob=blob,
            dataset=schema.dataset, model_type=schema.model_type,
            input_shape=schema.input_shape, layer_names=schema.layer_names)

    def download_model(self, schema: ModelSchema) -> ModelSchema:
        return self.download_by_name(schema.name)

    def load_variables(self, name: str) -> Dict[str, Any]:
        """Blob -> the flax-layout variables tree (numpy arrays), checked
        against the port module of the schema's spec."""
        schema = self.download_by_name(name)  # verifies the cached blob
        variables = flax_msgpack.unpackb(
            self.local.read_blob(schema, verify=False))
        convert.check_flax_variables(schema.network_spec, variables,
                                     schema.input_shape or None)
        return variables
