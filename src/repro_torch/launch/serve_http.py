"""HTTP front for the search service: JSON POST to one live driver.

Counterpart of ``repro.launch.serve_http``: the stdin front's
:func:`~repro_torch.launch.serve_search.handle_request` behind a stdlib
``ThreadingHTTPServer``, with the same flags plus the bind address.

  POST /            {"op": "submit", "tenant": "a", "plan": {...}}
  POST /            {"op": "stats"} | {"op": "drain"}
  GET  /stats       the same as {"op": "stats"}

One JSON body a request, one JSON response: HTTP 200 also for
``{"ok": false}`` protocol errors; the status is kept for transport
errors (400 malformed JSON, 404 unknown path, 405 PUT, DELETE and PATCH).
Shutdown drains.

  PYTHONPATH=src python -m repro_torch.launch.serve_http --device cpu --scale 0.02 --port 8080 &
  curl -d '{"op": "submit", "tenant": "a", "class": 0, \\
            "plan": {"result_limit": 5, "execution": {"queries_axis": true}}}' localhost:8080
"""
from __future__ import annotations

import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.launch.serve_search import build_parser, build_service, handle_request
from repro_torch.serve.service import SearchService


def make_server(service: SearchService, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
    """A threaded HTTP server over ``service`` (``port=0`` picks a free
    port: read it from ``server.server_address``).  The caller starts the
    service before serving and drains and stops it after
    ``server.shutdown()``."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self) -> None:  # noqa: N802 (stdlib naming)
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length)
            try:
                obj = json.loads(raw.decode() or "null")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                self._reply(400, {"ok": False, "error": f"bad JSON: {e}"})
                return
            if not isinstance(obj, dict):
                self._reply(400, {"ok": False, "error": "request body must be a JSON object"})
                return
            self._reply(200, handle_request(service, obj))

        def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
            if self.path.rstrip("/") in ("", "/stats"):
                self._reply(200, handle_request(service, {"op": "stats"}))
            else:
                self._reply(404, {"ok": False, "error": f"unknown path {self.path!r}"})

        def _refuse(self) -> None:
            self._reply(405, {"ok": False, "error": f"method {self.command} not allowed (POST, GET)"})

        do_PUT = do_DELETE = do_PATCH = _refuse  # noqa: N815 (stdlib naming)

        def log_message(self, fmt, *args) -> None:
            pass   # quiet: the service prints its own summary on stderr

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    ap = build_parser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    args = ap.parse_args(argv)

    service = build_service(args)
    server = make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"service: http://{host}:{port} (POST JSON ops; GET /stats)", file=sys.stderr)
    service.start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        if service.busy() or service.failure is not None:
            service.drain()   # shutdown drains, as the stdin front's EOF
        service.stop()
    print("service: clean drain", file=sys.stderr)


if __name__ == "__main__":
    main()
