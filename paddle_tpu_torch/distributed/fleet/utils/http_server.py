"""A small threaded key-value HTTP server for job rendezvous: the port
of `paddle_tpu/distributed/fleet/utils/http_server.py`.

PUT/GET/DELETE under /<scope>/<key> on a ThreadingHTTPServer, with
`KVHTTPServer.get_deleted_size()` so a barrier can count participants
(the start/stop protocol of the reference's KVServer); `KVClient` is the
client side. For launchers that need a rendezvous without one of
torch.distributed's stores.
"""
from __future__ import annotations

import http.server
import threading
import urllib.request


class _KVHandler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        self.server.kv[self.path] = self.rfile.read(n)
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        val = self.server.kv.get(self.path)
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_DELETE(self):
        if self.server.kv.pop(self.path, None) is not None:
            self.server.deleted += 1
        self.send_response(200)
        self.end_headers()


class KVHTTPServer(http.server.ThreadingHTTPServer):
    def __init__(self, port, handler=_KVHandler):
        super().__init__(("", port), handler)
        self.kv = {}
        self.deleted = 0

    def get_deleted_size(self, key=None):
        return self.deleted


class KVServer:
    """The server's start()/stop() lifecycle."""

    def __init__(self, port, size=None):
        self._port = port
        self._server = None
        self._thread = None
        self.size = size or {}

    @property
    def port(self):
        return self._port

    def start(self):
        self._server = KVHTTPServer(self._port)
        if self._port == 0:  # ephemeral: expose the bound port
            self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def should_stop(self):
        """True once every registered scope has been fully deleted —
        the reference's participant-countdown contract."""
        return self._server is not None and \
            self._server.get_deleted_size() >= sum(self.size.values() or [0])

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._server.server_close()
            self._server = None


class KVClient:
    """HTTP client side (PUT/GET/DELETE string values)."""

    def __init__(self, endpoint):
        self._base = f"http://{endpoint}"

    def put(self, key, value):
        data = value.encode() if isinstance(value, str) else value
        req = urllib.request.Request(self._base + key, data=data,
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status == 200

    def get(self, key):
        try:
            with urllib.request.urlopen(self._base + key, timeout=10) as r:
                return r.read().decode()
        except urllib.error.HTTPError:
            return ""

    def delete(self, key):
        req = urllib.request.Request(self._base + key, method="DELETE")
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status == 200
