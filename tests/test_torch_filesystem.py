"""PyTorch port: the filesystem registry (``utils/filesystem.py``), the
WebDAV test server (``testing/webdav.py``), and their consumers
(``io/binary.py`` remote reads, ``downloader.HTTPRepo``), held against
the JAX package on the same servers. Mirrors ``tests/test_filesystem.py``
and ``tests/test_remote_fs.py``; the learner's remote checkpoints are in
``tests/test_torch_checkpoint.py``.

The one stated divergence: the port's WebDAV read never retries a 4xx
reply, where the JAX package's retries a 429 (Too Many Requests).
"""

import http.server
import json
import os
import threading
import urllib.error

import numpy as np
import pytest

from mmlspark_tpu.downloader import HTTPRepo as JHTTPRepo
from mmlspark_tpu.io.binary import read_binary_files as jread_binary
from mmlspark_tpu.testing.webdav import serve_webdav as jserve_webdav
from mmlspark_tpu.utils import filesystem as jfs

from mmlspark_tpu_torch.downloader import (
    HTTPRepo, LocalRepo, ModelDownloader,
)
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.image import encode_image, read_images
from mmlspark_tpu_torch.testing.webdav import serve_webdav
from mmlspark_tpu_torch.utils import filesystem as fslib


def _serve_dir(root):
    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(root), **kw)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("httproot")
    (root / "a.txt").write_bytes(b"alpha")
    (root / "sub").mkdir()
    (root / "sub" / "b.bin").write_bytes(b"\x00\x01\x02")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = (255, 0, 0)
    (root / "img0.png").write_bytes(encode_image(img))
    (root / "_index.json").write_text(
        json.dumps(["a.txt", "sub/b.bin", "img0.png"]))
    return root


@pytest.fixture(scope="module")
def http_server(http_root):
    srv, url = _serve_dir(http_root)
    yield url
    srv.shutdown()


@pytest.fixture()
def dav(tmp_path):
    """The port's WebDAV server over a fresh directory."""
    server, base = serve_webdav(str(tmp_path / "store"))
    yield base, str(tmp_path / "store")
    server.shutdown()
    server.server_close()


class TestHTTPFileSystem:
    def test_read_bytes(self, http_server):
        fs = fslib.get_filesystem(http_server)
        assert fs.read_bytes(f"{http_server}/a.txt") == b"alpha"

    def test_exists(self, http_server):
        fs = fslib.get_filesystem(http_server)
        assert fs.exists(f"{http_server}/a.txt")
        assert not fs.exists(f"{http_server}/nope.txt")

    def test_list_files_via_index(self, http_server):
        fs = fslib.get_filesystem(http_server)
        files = fs.list_files(http_server)
        assert files == jfs.get_filesystem(http_server).list_files(
            http_server)
        assert len(files) == 3
        only_txt = fs.list_files(http_server, pattern="*.txt")
        assert only_txt == [f"{http_server}/a.txt"]

    def test_retry_then_fail(self):
        fs = fslib.HTTPFileSystem(retries=2, timeout=1.0)
        with pytest.raises(urllib.error.URLError):
            fs.read_bytes("http://127.0.0.1:1/never.bin")

    def test_scheme_routing(self, tmp_path):
        p = tmp_path / "x.bin"
        p.write_bytes(b"local")
        assert fslib.read_bytes(str(p)) == b"local"
        assert fslib.read_bytes(f"file://{p}") == b"local"
        for path in ("s3://bucket/key", "C:/data/x.bin", "/abs/x"):
            assert fslib.scheme_of(path) == jfs.scheme_of(path)
        with pytest.raises(KeyError, match="no filesystem registered"):
            fslib.get_filesystem("s3://bucket/key")

    def test_register_custom_scheme(self):
        class MemFS(fslib.FileSystem):
            def read_bytes(self, path):
                return b"mem:" + path.encode()
        fslib.register_filesystem("memport", MemFS())
        assert fslib.read_bytes("memport://x") == b"mem:memport://x"
        with pytest.raises(NotImplementedError, match="read-only"):
            fslib.write_bytes("memport://x", b"")


class TestRemoteReaders:
    def test_read_binary_files_http(self, http_server):
        t = read_binary_files(http_server)
        j = jread_binary(http_server)
        assert [(r["value"]["path"], bytes(r["value"]["bytes"]))
                for r in t.rows()] == \
            [(r["value"]["path"], bytes(r["value"]["bytes"]))
             for r in j.rows()]
        assert len(t) == 3

    def test_read_images_http(self, http_server):
        t = read_images(http_server)
        assert len(t) == 1
        assert t["image"][0]["data"].shape == (8, 8, 3)


class TestHTTPRepo:
    @pytest.fixture(scope="class")
    def repo_server(self, tmp_path_factory):
        from mmlspark_tpu_torch.models.networks import build_network
        from mmlspark_tpu_torch import convert
        tmp = tmp_path_factory.mktemp("httprepo")
        spec = {"type": "mlp", "features": [8], "num_classes": 2}
        mod = build_network(dict(spec, in_features=4), device="cpu")
        values = {k: t.detach().numpy()
                  for k, t in mod.state_dict().items()}
        variables = {"params": convert.flax_collections(
            mod, values)["params"]}
        schema = LocalRepo(str(tmp)).publish(
            "TinyMLP", spec, variables, input_shape=[4],
            model_type="tabular")
        srv, url = _serve_dir(tmp)
        yield url, schema, tmp
        srv.shutdown()

    def test_remote_download_verifies_sha(self, repo_server, tmp_path):
        url, schema, _ = repo_server
        dl = ModelDownloader(str(tmp_path / "cache"), repo=HTTPRepo(url))
        got = dl.download_by_name("TinyMLP")
        assert got.sha256 == schema.sha256
        # the cached copy now serves without the remote
        dl2 = ModelDownloader(str(tmp_path / "cache"), repo=None)
        v = dl2.load_variables("TinyMLP")
        assert "params" in v

    def test_list_remote_schemas(self, repo_server):
        url, _, _ = repo_server
        names = [s.name for s in HTTPRepo(url).list_schemas()]
        assert names == [s.name for s in JHTTPRepo(url).list_schemas()]
        assert names == ["TinyMLP"]

    def test_corrupt_blob_rejected(self, repo_server, tmp_path):
        url, _, root = repo_server
        blob_path = root / "TinyMLP.msgpack"
        good = blob_path.read_bytes()
        try:
            blob_path.write_bytes(good + b"tampered")
            dl = ModelDownloader(str(tmp_path / "c2"),
                                 repo=HTTPRepo(url, retries=1))
            with pytest.raises(IOError, match="sha256 mismatch"):
                dl.download_by_name("TinyMLP")
        finally:
            blob_path.write_bytes(good)


class TestWebDAVFileSystem:
    @pytest.mark.parametrize("serve", [serve_webdav, jserve_webdav])
    def test_either_packages_server(self, tmp_path, serve):
        """The port's client against both packages' servers: a nested
        PUT, a listing equal to the JAX client's, a delete."""
        server, base = serve(str(tmp_path / "s"))
        try:
            fslib.write_bytes(f"{base}/d/sub/x.bin", b"xyz")
            fslib.write_bytes(f"{base}/d/y.txt", b"y")
            fs = fslib.get_filesystem(base)
            assert fs.list_files(f"{base}/d") == \
                jfs.get_filesystem(base).list_files(f"{base}/d")
            assert jfs.read_bytes(f"{base}/d/sub/x.bin") == b"xyz"
            fs.delete_path(f"{base}/d/sub/")
            assert not fs.exists(f"{base}/d/sub/x.bin")
        finally:
            server.shutdown()
            server.server_close()

    def test_roundtrip_and_exists(self, dav):
        base, _ = dav
        url = f"{base}/a/b/data.bin"
        payload = os.urandom(4096)
        assert not fslib.get_filesystem(url).exists(url)
        fslib.write_bytes(url, payload)   # creates a/ and a/b/ (MKCOL)
        assert fslib.get_filesystem(url).exists(url)
        assert fslib.read_bytes(url) == payload
        assert jfs.read_bytes(url) == payload

    def test_overwrite(self, dav):
        base, _ = dav
        url = f"{base}/f.txt"
        fslib.write_bytes(url, b"one")
        fslib.write_bytes(url, b"two")
        assert fslib.read_bytes(url) == b"two"

    def test_list_recursive_and_pattern(self, dav):
        base, _ = dav
        fslib.write_bytes(f"{base}/d/x.npy", b"1")
        fslib.write_bytes(f"{base}/d/sub/y.npy", b"2")
        fslib.write_bytes(f"{base}/d/sub/z.txt", b"3")
        fs, jf = fslib.get_filesystem(base), jfs.get_filesystem(base)
        for kw in ({}, {"pattern": "*.npy"}, {"recursive": False}):
            assert fs.list_files(f"{base}/d", **kw) == \
                jf.list_files(f"{base}/d", **kw), kw
        assert {u.rsplit("/", 1)[1] for u in fs.list_files(f"{base}/d")} \
            == {"x.npy", "y.npy", "z.txt"}
        assert {u.rsplit("/", 1)[1] for u in fs.list_files(
            f"{base}/d", recursive=False)} == {"x.npy"}
        # listing a missing dir is empty, not an error (resume from
        # nothing)
        assert fs.list_files(f"{base}/nothere") == []

    def test_delete(self, dav):
        base, _ = dav
        fs = fslib.get_filesystem(base)
        fslib.write_bytes(f"{base}/gone/f1", b"x")
        fslib.write_bytes(f"{base}/gone/f2", b"y")
        fs.delete_path(f"{base}/gone/")
        assert fs.list_files(f"{base}/gone") == []
        assert not fs.exists(f"{base}/gone/f1")
        fs.delete_path(f"{base}/gone/")      # a missing path: no error

    def test_traversal_rejected(self, dav):
        base, root = dav
        fs = fslib.get_filesystem(base)
        with pytest.raises(urllib.error.HTTPError):
            fs.write_bytes(f"{base}/../escape.txt", b"x")
        assert not os.path.exists(
            os.path.join(os.path.dirname(root), "escape.txt"))

    @pytest.mark.parametrize("serve", [serve_webdav, jserve_webdav])
    def test_depth1_fallback_when_infinity_refused(self, tmp_path, serve):
        """Apache mod_dav refuses Depth: infinity by default (RFC 4918
        §9.1) — recursive listing falls back to Depth-1 recursion."""
        server, base = serve(str(tmp_path / "s"),
                             allow_depth_infinity=False)
        try:
            fslib.write_bytes(f"{base}/d/x.npy", b"1")
            fslib.write_bytes(f"{base}/d/sub/deep/y.npy", b"2")
            got = {u.rsplit("/", 1)[1]
                   for u in fslib.get_filesystem(base).list_files(
                       f"{base}/d")}
            assert got == {"x.npy", "y.npy"}
        finally:
            server.shutdown()
            server.server_close()

    def test_registry_schemes(self):
        assert isinstance(fslib.get_filesystem("webdav://h/x"),
                          fslib.WebDAVFileSystem)
        assert isinstance(fslib.get_filesystem("webdavs://h/x"),
                          fslib.WebDAVFileSystem)
        assert isinstance(fslib.get_filesystem("https://h/x"),
                          fslib.HTTPFileSystem)

    def test_names_with_spaces_roundtrip(self, dav):
        """webdav paths are PLAIN names; percent-encoding happens on the
        wire only."""
        base, _ = dav
        url = f"{base}/dir with space/my file.bin"
        fslib.write_bytes(url, b"spacey")
        fs = fslib.get_filesystem(url)
        assert fs.exists(url)
        assert fslib.read_bytes(url) == b"spacey"
        listed = fs.list_files(f"{base}/dir with space")
        assert listed == [url]
        assert fslib.read_bytes(listed[0]) == b"spacey"


class _Counting(http.server.BaseHTTPRequestHandler):
    """Answers every GET with ``code`` and counts the requests."""
    code = 429
    hits = 0

    def do_GET(self):
        type(self).hits += 1
        self.send_response(self.code)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.mark.parametrize("code", [404, 429])
def test_webdav_read_never_retries_a_4xx(code):
    """The stated divergence: the port's WebDAV read (``_request``) fails
    at once on any 4xx. The JAX package's (``HTTPFileSystem._fetch``)
    fails at once on a 404 too, but retries a 429."""
    handler = type("H", (_Counting,), {"code": code, "hits": 0})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"webdav://127.0.0.1:{srv.server_address[1]}/x.bin"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            fslib.WebDAVFileSystem(retries=3).read_bytes(url)
        assert e.value.code == code and handler.hits == 1
        handler.hits = 0
        with pytest.raises(urllib.error.HTTPError):
            jfs.WebDAVFileSystem(retries=3).read_bytes(url)
        assert handler.hits == (3 if code == 429 else 1)
    finally:
        srv.shutdown()
        srv.server_close()


class TestDownloaderRemotePublish:
    def test_publish_fetch_roundtrip(self, dav):
        """Publish a blob to the WebDAV repo, list it, download it with
        sha256 verification; the JAX package reads the same repo."""
        base, _ = dav
        repo = HTTPRepo(f"{base}/zoo")
        blob = os.urandom(2048)
        schema = repo.publish(
            "tiny_model", {"type": "mlp", "features": [4]},
            blob=blob, model_type="classification", dataset="synthetic")
        assert schema.sha256
        repo2 = HTTPRepo(f"{base}/zoo")
        assert [s.name for s in repo2.list_schemas()] == ["tiny_model"]
        assert repo2.read_blob(repo2.get_schema("tiny_model")) == blob
        jrepo = JHTTPRepo(f"{base}/zoo")
        assert jrepo.read_blob(jrepo.get_schema("tiny_model")) == blob

    def test_download_caches_locally(self, dav, tmp_path):
        base, _ = dav
        HTTPRepo(f"{base}/zoo").publish("m1", {"type": "mlp"},
                                        blob=b"m" * 512)
        dl = ModelDownloader(local_path=str(tmp_path / "cache"),
                             repo=HTTPRepo(f"{base}/zoo"))
        schema = dl.download_by_name("m1")
        assert dl.local.read_blob(schema) == b"m" * 512

    def test_corrupted_remote_blob_rejected(self, dav):
        base, _ = dav
        repo = HTTPRepo(f"{base}/zoo", retries=1)
        repo.publish("m2", {"type": "mlp"}, blob=b"good-bytes")
        fslib.write_bytes(f"{base}/zoo/m2.msgpack", b"evil-bytes")
        with pytest.raises(IOError, match="sha256"):
            repo.read_blob(repo.get_schema("m2"))


def test_read_binary_files_webdav(dav):
    base, _ = dav
    fslib.write_bytes(f"{base}/blobs/a.bin", b"AAA")
    fslib.write_bytes(f"{base}/blobs/deep/b.bin", b"BBBB")
    fslib.write_bytes(f"{base}/blobs/deep/c.txt", b"CC")
    for kw in ({"pattern": "*.bin"}, {"recursive": False},
               {"sample_ratio": 0.5, "seed": 3}):
        table = read_binary_files(f"{base}/blobs", **kw)
        jtable = jread_binary(f"{base}/blobs", **kw)
        got = [(r["value"]["path"], bytes(r["value"]["bytes"]))
               for r in table.rows()]
        assert got == [(r["value"]["path"], bytes(r["value"]["bytes"]))
                       for r in jtable.rows()], kw
    got = {r["value"]["path"].rsplit("/", 1)[1]: bytes(r["value"]["bytes"])
           for r in read_binary_files(f"{base}/blobs",
                                      pattern="*.bin").rows()}
    assert got == {"a.bin": b"AAA", "b.bin": b"BBBB"}
