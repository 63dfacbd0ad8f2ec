"""In-process WebDAV server — the remote-storage test double of the
PyTorch port: a copy of ``mmlspark_tpu/testing/webdav.py`` (stdlib only),
so the port's tests and ``chip_smoke.py`` need nothing of the JAX package.

The reference's remote-FS integration tests run against live HDFS/wasb
only in E2E clusters; its unit layer fakes the seam (ref: SURVEY.md §4
— tests substitute local FS for remote). Here the seam is the
``webdav://`` scheme (``mmlspark_tpu_torch/utils/filesystem.py``), and this
server is a real standards-subset WebDAV endpoint over a local
directory: GET / HEAD / PUT (201, 409 when the parent collection is
missing) / MKCOL / DELETE / PROPFIND (Depth 1 or infinity,
multistatus XML with collection markers). Runs threaded in-process, so
checkpoint/resume, ModelDownloader.publish, and read_binary_files
exercise their genuine remote code paths in unit tests — including
from OTHER processes (the multi-host fixture's workers hit it over
localhost).
"""

from __future__ import annotations

import os
import shutil
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple


class _DAVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    root: str = "."                    # set by serve_webdav
    allow_infinity: bool = True        # False mimics Apache mod_dav

    # -- helpers -----------------------------------------------------------

    def _local(self) -> Optional[str]:
        rel = urllib.parse.unquote(
            urllib.parse.urlparse(self.path).path).lstrip("/")
        if ".." in rel.split("/"):
            return None
        return os.path.join(self.root, rel) if rel else self.root

    def _reply(self, code: int, body: bytes = b"",
               ctype: str = "application/octet-stream") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def log_message(self, *a):          # quiet
        pass

    # -- verbs -------------------------------------------------------------

    def do_GET(self):
        p = self._local()
        if p is None or not os.path.isfile(p):
            return self._reply(404)
        with open(p, "rb") as f:
            self._reply(200, f.read())

    def do_HEAD(self):
        p = self._local()
        if p is not None and os.path.exists(p):
            self._reply(200)
        else:
            self._reply(404)

    def do_PUT(self):
        # drain the body FIRST: replying 409/403 with unread body bytes
        # would corrupt a keep-alive connection (the leftover bytes
        # parse as the next request line)
        n = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(n) if n else b""
        p = self._local()
        if p is None:
            return self._reply(403)
        if not os.path.isdir(os.path.dirname(p)):
            # DAV: PUT into a missing collection is 409 Conflict
            return self._reply(409)
        existed = os.path.exists(p)
        with open(p, "wb") as f:
            f.write(data)
        self._reply(204 if existed else 201)

    def do_MKCOL(self):
        p = self._local()
        if p is None:
            return self._reply(403)
        if os.path.isdir(p):
            return self._reply(405)     # already exists
        if not os.path.isdir(os.path.dirname(p)):
            return self._reply(409)
        os.mkdir(p)
        self._reply(201)

    def do_DELETE(self):
        p = self._local()
        if p is None or not os.path.exists(p):
            return self._reply(404)
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.remove(p)
        self._reply(204)

    def do_PROPFIND(self):
        p = self._local()
        if p is None or not os.path.exists(p):
            return self._reply(404)
        # consume any request body (some clients send a propfind doc)
        n = int(self.headers.get("Content-Length", 0))
        if n:
            self.rfile.read(n)
        depth = self.headers.get("Depth", "1")
        if depth.lower() == "infinity" and not self.allow_infinity:
            # RFC 4918 §9.1: servers MAY refuse infinite-depth PROPFIND
            # (Apache mod_dav's default) — clients must fall back
            return self._reply(403)
        base = urllib.parse.urlparse(self.path).path.rstrip("/")
        entries = [(base + ("/" if os.path.isdir(p) else ""), p)]
        if os.path.isdir(p):
            if depth == "1":
                for name in sorted(os.listdir(p)):
                    fp = os.path.join(p, name)
                    href = f"{base}/{name}" + (
                        "/" if os.path.isdir(fp) else "")
                    entries.append((href, fp))
            elif depth.lower() == "infinity":
                for dirpath, dirnames, filenames in os.walk(p):
                    rel = os.path.relpath(dirpath, p)
                    prefix = base if rel == "." else \
                        f"{base}/{rel.replace(os.sep, '/')}"
                    for d in sorted(dirnames):
                        entries.append((f"{prefix}/{d}/",
                                        os.path.join(dirpath, d)))
                    for fn in sorted(filenames):
                        entries.append((f"{prefix}/{fn}",
                                        os.path.join(dirpath, fn)))
        parts = ['<?xml version="1.0" encoding="utf-8"?>',
                 '<D:multistatus xmlns:D="DAV:">']
        for href, fp in entries:
            is_dir = href.endswith("/") or os.path.isdir(fp)
            rtype = "<D:collection/>" if is_dir else ""
            parts.append(
                f"<D:response><D:href>{href}</D:href>"
                f"<D:propstat><D:prop>"
                f"<D:resourcetype>{rtype}</D:resourcetype>"
                f"</D:prop><D:status>HTTP/1.1 200 OK</D:status>"
                f"</D:propstat></D:response>")
        parts.append("</D:multistatus>")
        self._reply(207, "\n".join(parts).encode("utf-8"),
                    ctype='application/xml; charset="utf-8"')


def serve_webdav(root: str, host: str = "127.0.0.1", port: int = 0,
                 allow_depth_infinity: bool = True,
                 ) -> Tuple[ThreadingHTTPServer, str]:
    """Start a threaded WebDAV server over ``root``; returns
    (server, base_url) where base_url uses the ``webdav://`` scheme.
    ``allow_depth_infinity=False`` refuses infinite-depth PROPFIND with
    403 (the Apache mod_dav default posture) so clients' Depth-1
    fallback is testable. Call ``server.shutdown()`` to stop."""
    os.makedirs(root, exist_ok=True)
    handler = type("Handler", (_DAVHandler,),
                   {"root": root,
                    "allow_infinity": allow_depth_infinity})
    server = ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, f"webdav://{host}:{server.server_address[1]}"
