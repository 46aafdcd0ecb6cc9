"""Statement-protocol proxy of the PyTorch port: one public endpoint in
front of a coordinator (``presto_tpu/server/proxy.py``).

Clients talk to the proxy; it forwards ``/v1/...`` requests to the backend
and rewrites every URI in the protocol's URI fields of a JSON answer so
that the client keeps talking to the proxy. Result data is never rewritten.
Auth headers and ``X-Presto-*`` headers pass through; a backend that does
not answer is a 502.

Run: ``python -m presto_tpu_torch.server.proxy --backend http://host:port
[--port N] [--public-base URI]``; embed with ``ProxyServer``.
"""
from __future__ import annotations

import argparse
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

# hop-by-hop plus headers send_response() emits itself (a duplicate Date/
# Server violates RFC 9110's single-instance requirement)
_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "host",
                "content-length", "date", "server"}


class _ProxyHandler(BaseHTTPRequestHandler):
    backend: str = ""
    public_base: Optional[str] = None

    def log_message(self, fmt, *args):  # noqa: A003 - quiet
        pass

    # ------------------------------------------------------------ plumbing

    def _public(self) -> str:
        if self.public_base:
            return self.public_base
        host = self.headers.get("Host") or \
            f"{self.server.server_address[0]}:{self.server.server_address[1]}"
        return f"http://{host}"

    def _forward(self, method: str) -> None:
        if not self.path.startswith("/v1/"):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else None
        url = self.backend + self.path
        req = urllib.request.Request(url, data=body, method=method)
        for k, v in self.headers.items():
            # accept-encoding is dropped so the backend answers identity —
            # the proxy must read the JSON to rewrite URIs
            if k.lower() not in _HOP_HEADERS and \
                    k.lower() != "accept-encoding":
                req.add_header(k, v)
        resp_headers = []
        try:
            with urllib.request.urlopen(req, timeout=120.0) as resp:
                payload = resp.read()
                status = resp.status
                resp_headers = list(resp.headers.items())
                ctype = resp.headers.get("Content-Type", "application/json")
        except urllib.error.HTTPError as e:
            payload = e.read()
            status = e.code
            resp_headers = list(e.headers.items())
            ctype = e.headers.get("Content-Type", "application/json")
        except (urllib.error.URLError, OSError) as e:
            payload = json.dumps(
                {"error": f"proxy backend unreachable: {e}"}).encode()
            status = 502
            ctype = "application/json"
        if ctype.startswith("application/json"):
            payload = self._rewrite(payload)
        self.send_response(status)
        for k, v in resp_headers:  # X-Presto-* etc. pass through
            if k.lower() not in _HOP_HEADERS:
                self.send_header(k, v)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    # protocol fields that carry engine URIs (client/StatementClient +
    # webapp links); ONLY these rewrite — data values must never change
    _URI_FIELDS = {"nextUri", "infoUri", "partialCancelUri", "self", "uri",
                   "link"}

    def _rewrite(self, payload: bytes) -> bytes:
        """Backend URIs -> proxy URIs, in PROTOCOL URI FIELDS only
        (ProxyResource's uri rewriting; result data stays untouched)."""
        try:
            doc = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return payload
        public = self._public()

        def walk(node):
            if isinstance(node, dict):
                for k, v in node.items():
                    if k in self._URI_FIELDS and isinstance(v, str) and \
                            v.startswith(self.backend):
                        node[k] = public + v[len(self.backend):]
                    else:
                        walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(doc)
        return json.dumps(doc).encode()

    # -------------------------------------------------------------- verbs

    def do_GET(self):  # noqa: N802
        self._forward("GET")

    def do_POST(self):  # noqa: N802
        self._forward("POST")

    def do_DELETE(self):  # noqa: N802
        self._forward("DELETE")


class ProxyServer:
    """Embeddable proxy (presto-proxy's ProxyServer)."""

    def __init__(self, backend: str, port: int = 0,
                 public_base: Optional[str] = None):
        handler = type("Handler", (_ProxyHandler,), {
            "backend": backend.rstrip("/"),
            "public_base": public_base.rstrip("/") if public_base else None,
        })
        self.httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ProxyServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="presto_tpu_torch statement proxy")
    ap.add_argument("--backend", required=True,
                    help="coordinator base URI, e.g. http://host:8080")
    ap.add_argument("--port", type=int, default=8443)
    ap.add_argument("--public-base", default=None,
                    help="advertised base URI when behind a load balancer")
    args = ap.parse_args(argv)
    server = ProxyServer(args.backend, args.port, args.public_base)
    print(f"proxy on :{server.port} -> {args.backend}", flush=True)  # prestocheck: ignore[print-hygiene] - CLI startup banner
    server.httpd.serve_forever()


if __name__ == "__main__":
    main()
