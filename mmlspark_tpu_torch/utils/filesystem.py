"""Pluggable remote/local filesystem layer of the PyTorch port: a copy of
``mmlspark_tpu/utils/filesystem.py`` (the port imports nothing of the
JAX package).

The analog of the reference's Hadoop-FS indirection
(ref: src/core/hadoop/src/main/scala/HadoopUtils.scala and the remote
reads in ModelDownloader.scala:54-124 HDFSRepo): ``io/binary.py``'s
readers, the downloader's ``HTTPRepo`` and the learner's checkpoints
resolve paths through a scheme-keyed filesystem registry, so remote
storage backends plug in without touching the readers. ``file://`` (and
bare paths) map to the local FS; ``http(s)://`` is built in (read-only,
retrying); ``webdav(s)://`` is writable; other stores register their own
implementation via ``register_filesystem``.

One stated divergence: ``WebDAVFileSystem.read_bytes`` GETs through the
verb path (``_request``), where no 4xx reply is retried. The JAX
package's WebDAV read goes through ``HTTPFileSystem._fetch``, which
retries a 429 (Too Many Requests) with backoff; here a 429 fails at
once, like every other client error of a WebDAV verb.
"""

from __future__ import annotations

import fnmatch
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple


class FileSystem:
    """Interface: implement and ``register_filesystem(scheme, fs)``."""

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError(f"{type(self).__name__} is read-only")

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def delete_path(self, path: str) -> None:
        raise NotImplementedError(f"{type(self).__name__} cannot delete")

    def list_files(self, path: str, pattern: Optional[str] = None,
                   recursive: bool = True) -> List[str]:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    @staticmethod
    def _strip(path: str) -> str:
        return path[len("file://"):] if path.startswith("file://") else path

    def read_bytes(self, path: str) -> bytes:
        with open(self._strip(path), "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        p = self._strip(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def delete_path(self, path: str) -> None:
        import shutil
        p = self._strip(path)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)

    def list_files(self, path: str, pattern: Optional[str] = None,
                   recursive: bool = True) -> List[str]:
        from mmlspark_tpu_torch.utils.file_utils import recursive_list_files
        return recursive_list_files(self._strip(path), pattern, recursive)


class HTTPFileSystem(FileSystem):
    """Read-only HTTP(S) backend with retry-with-backoff on transient
    errors (the remote-fetch semantics of ModelDownloader.scala:37-50).

    Listing a "directory" requires the server to expose an
    ``_index.json`` file next to the objects: a JSON list of relative
    paths (how a static bucket or the zoo repo publishes its contents).
    """

    def __init__(self, retries: int = 3, timeout: float = 30.0):
        self.retries = retries
        self.timeout = timeout

    def _fetch(self, url: str) -> bytes:
        def once() -> bytes:
            try:
                with urllib.request.urlopen(url, timeout=self.timeout) as r:
                    return r.read()
            except urllib.error.HTTPError as e:
                # 4xx (bar 429) is deterministic — a missing object will
                # still be missing after the backoff; don't burn budget
                if 400 <= e.code < 500 and e.code != 429:
                    raise _NoRetry(e) from e
                raise

        return _call_with_retry(once, self.retries, "http_fs")

    def read_bytes(self, path: str) -> bytes:
        return self._fetch(path)

    def exists(self, path: str) -> bool:
        req = urllib.request.Request(path, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise
        except urllib.error.URLError:
            return False

    def list_files(self, path: str, pattern: Optional[str] = None,
                   recursive: bool = True) -> List[str]:
        import json
        base = path.rstrip("/")
        names = json.loads(self._fetch(f"{base}/_index.json").decode())
        out = []
        for name in names:
            if not recursive and "/" in name:
                continue   # nested entry — match local non-recursive
            leaf = name.rsplit("/", 1)[-1]
            if pattern is None or fnmatch.fnmatch(leaf, pattern):
                out.append(f"{base}/{name}")
        return out


class _NoRetry(Exception):
    """Wraps a deterministic (4xx) HTTP error so the retry loop
    re-raises it immediately instead of backing off."""

    def __init__(self, error):
        self.error = error


def _call_with_retry(once, retries: int, name: str):
    """Shared retry wrapper for the HTTP/WebDAV verbs: run ``once``
    (which wraps its own deterministic failures in ``_NoRetry``) under
    the unified RetryPolicy, unwrapping fast-fail errors back to the
    original exception."""
    from mmlspark_tpu_torch.utils.resilience import RetryPolicy
    try:
        return RetryPolicy(max_attempts=max(1, retries),
                           no_retry=(_NoRetry,), name=name).call(once)
    except _NoRetry as e:
        raise e.error


class WebDAVFileSystem(HTTPFileSystem):
    """WRITABLE HTTP backend — WebDAV verbs over plain stdlib urllib
    (the role the reference's HDFS/wasb layer plays for staging training
    data, checkpoints, and published models: CNTKLearner.scala:18-67
    ``dataTransfer=hdfs``, HdfsWriter DataConversion.scala:230,
    HDFSRepo ModelDownloader.scala:54-124).

    Paths use the ``webdav://`` / ``webdavs://`` schemes (mapping to
    http/https transport) so read-only ``http://`` keeps its existing
    semantics. write_bytes PUTs, creating missing parent collections
    with MKCOL on a 409; listing is PROPFIND (Depth: infinity when
    recursive), parsed from the multistatus hrefs; delete_path issues
    DELETE. Works against any standards-following server — the in-tree
    ``mmlspark_tpu_torch.testing.webdav`` server is the test double."""

    @staticmethod
    def _http_url(path: str) -> str:
        """webdav(s):// path -> final http(s) URL with the path
        component percent-encoded. Convention: webdav paths are PLAIN
        (unencoded) names — a file called 'my file.bin' is addressed as
        .../my file.bin and encoded here, on the wire only."""
        if path.startswith("webdavs://"):
            path = "https://" + path[len("webdavs://"):]
        elif path.startswith("webdav://"):
            path = "http://" + path[len("webdav://"):]
        parsed = urllib.parse.urlsplit(path)
        return urllib.parse.urlunsplit(parsed._replace(
            path=urllib.parse.quote(parsed.path)))

    def _request(self, url: str, method: str, data: bytes = None,
                 headers: Optional[Dict[str, str]] = None,
                 ok: tuple = (200, 201, 204, 207),
                 retry: bool = True) -> bytes:
        """One verb against a FINAL (already-encoded) http URL, retried
        with backoff on transient errors like the read/write paths (4xx
        client errors don't retry — they are deterministic)."""

        def once() -> bytes:
            req = urllib.request.Request(
                url, data=data, method=method, headers=headers or {})
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout) as r:
                    if r.status not in ok:
                        raise IOError(f"{method} {url}: HTTP {r.status}")
                    return r.read()
            except urllib.error.HTTPError as e:
                if 400 <= e.code < 500:
                    raise _NoRetry(e) from e
                raise

        return _call_with_retry(once, self.retries if retry else 1,
                                "webdav")

    def read_bytes(self, path: str) -> bytes:
        # GET through the verb path: no 4xx reply is retried (the JAX
        # package's read retries a 429; see the module docstring)
        return self._request(self._http_url(path), "GET", ok=(200,))

    def write_bytes(self, path: str, data: bytes) -> None:
        url = self._http_url(path)
        try:
            self._request(url, "PUT", data=data)
        except urllib.error.HTTPError as e:
            if e.code != 409:
                raise
            self._mkcols(url)
            self._request(url, "PUT", data=data)

    def _mkcols(self, url: str) -> None:
        """Create missing parent collections, shallowest first (the
        DAV spec's 409 for a PUT with no parent)."""
        parsed = urllib.parse.urlparse(url)
        root = f"{parsed.scheme}://{parsed.netloc}"
        parts = parsed.path.strip("/").split("/")[:-1]
        cur = root
        for part in parts:
            cur = f"{cur}/{part}"
            try:
                self._request(cur, "MKCOL", ok=(200, 201, 204))
            except urllib.error.HTTPError as e:
                if e.code not in (301, 405):   # exists already
                    raise

    def exists(self, path: str) -> bool:
        return super().exists(self._http_url(path))

    def delete_path(self, path: str) -> None:
        try:
            self._request(self._http_url(path), "DELETE")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def _propfind(self, url: str, depth: str
                  ) -> Tuple[List[str], List[str]]:
        """One PROPFIND against a final URL -> (file paths, collection
        paths) as ENCODED absolute server paths (ready for follow-up
        requests), excluding the queried url itself."""
        import re
        body = self._request(url, "PROPFIND", headers={"Depth": depth})
        self_path = urllib.parse.urlparse(url).path.rstrip("/")
        files: List[str] = []
        dirs: List[str] = []
        for href in re.findall(rb"<(?:[A-Za-z]\w*:)?href>([^<]+)</",
                               body):
            h = href.decode("utf-8").strip()
            h_path = urllib.parse.urlparse(h).path or h
            if not h_path.startswith("/"):
                h_path = "/" + h_path
            if h_path.endswith("/"):
                if h_path.rstrip("/") != self_path:
                    dirs.append(h_path.rstrip("/"))
            else:
                files.append(h_path)
        return files, dirs

    def list_files(self, path: str, pattern: Optional[str] = None,
                   recursive: bool = True) -> List[str]:
        url = self._http_url(path).rstrip("/")
        parsed = urllib.parse.urlparse(url)
        scheme = "webdavs" if parsed.scheme == "https" else "webdav"
        root = f"{scheme}://{parsed.netloc}"
        http_root = f"{parsed.scheme}://{parsed.netloc}"
        try:
            if recursive:
                # RFC 4918 lets servers refuse Depth: infinity (Apache
                # mod_dav does by default, 403) — fall back to manual
                # Depth:1 recursion over collections
                try:
                    files, _ = self._propfind(url, "infinity")
                except urllib.error.HTTPError as e:
                    if e.code not in (400, 403, 405):
                        raise
                    files = []
                    todo = [parsed.path.rstrip("/")]
                    while todo:
                        f1, d1 = self._propfind(
                            f"{http_root}{todo.pop()}", "1")
                        files.extend(f1)
                        todo.extend(d1)
            else:
                files, _ = self._propfind(url, "1")
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return []
            raise
        out = []
        for h_path in files:
            # hrefs are percent-encoded on the wire; returned webdav://
            # paths are PLAIN, matching the write-side convention
            dec = urllib.parse.unquote(h_path)
            leaf = dec.rsplit("/", 1)[-1]
            if pattern is None or fnmatch.fnmatch(leaf, pattern):
                out.append(f"{root}{dec}")
        return sorted(set(out))


_REGISTRY: Dict[str, FileSystem] = {}
_FACTORIES: Dict[str, Callable[[], FileSystem]] = {
    "file": LocalFileSystem,
    "http": HTTPFileSystem,
    "https": HTTPFileSystem,
    "webdav": WebDAVFileSystem,
    "webdavs": WebDAVFileSystem,
}


def register_filesystem(scheme: str, fs: FileSystem) -> None:
    """Plug in a storage backend (s3, gs, hdfs, ...) for ``scheme://``."""
    _REGISTRY[scheme] = fs


def scheme_of(path: str) -> str:
    parsed = urllib.parse.urlparse(path)
    # windows drive letters / bare paths have no usable scheme
    return parsed.scheme if len(parsed.scheme) > 1 else "file"


def get_filesystem(path: str) -> FileSystem:
    scheme = scheme_of(path)
    if scheme in _REGISTRY:
        return _REGISTRY[scheme]
    if scheme in _FACTORIES:
        _REGISTRY[scheme] = _FACTORIES[scheme]()
        return _REGISTRY[scheme]
    raise KeyError(
        f"no filesystem registered for scheme {scheme!r} "
        f"(path {path!r}); call register_filesystem({scheme!r}, fs)")


def read_bytes(path: str) -> bytes:
    return get_filesystem(path).read_bytes(path)


def write_bytes(path: str, data: bytes) -> None:
    get_filesystem(path).write_bytes(path, data)
