"""Minimal HTTP front end for ``CaptionService`` (standard library only;
counterpart of ``lrcn_tpu/serve/http.py``, with the same routes, statuses
and connection handling).

Endpoints:

- ``POST /v1/caption`` — JSON body with ONE of:
    ``{"id": 123}`` / ``{"ids": [...]}``        feature-store lookup
    ``{"features": [[...], ...]}``              raw fc7 rows
    ``{"image_b64": "..."}`` / ``{"images_b64": [...]}``  encoded images
  Response: ``{"captions": [...]}``.
- ``GET /healthz`` — liveness and the service's device type
  (``{"ok": true, "platform": "cuda"}``).
- ``GET /stats``  — per-stage dynamic-batching counters/latencies.

Errors map to statuses: malformed body 400, unknown route 404, body over
``MAX_BODY_BYTES`` 413, backpressure (``max_queue`` exceeded) 503,
device-wait timeout 504, stage failure 500; the server keeps serving
through all of them.

``ThreadingHTTPServer`` gives one thread per connection; all device work
still funnels through the service's dispatcher threads, so concurrent
requests coalesce into batched searches (serve/batcher.py).
"""

from __future__ import annotations

import base64
import json
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lrcn_tpu_torch.serve.batcher import BatcherOverloaded
from lrcn_tpu_torch.serve.service import CaptionService

# 64 MB: a full encode batch of base64 JPEGs fits with room to spare;
# anything larger is a mistake or an attack (mapped to 413)
MAX_BODY_BYTES = 64 << 20


def make_handler(service: CaptionService):
    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 -> persistent connections: without keep-alive every
        # request pays a connect and a thread spawn.  Every _reply sends
        # Content-Length, so 1.1 framing is always valid.
        protocol_version = "HTTP/1.1"

        # No HTTP/0.9: the stdlib answers 2-word request lines (and some
        # parse errors) with a raw body and no status line, which desyncs
        # any modern client.  Defaulting the version to 1.1 frames every
        # response.
        default_request_version = "HTTP/1.1"

        # A stalled client must not pin a connection thread forever: reads
        # that exceed the service's request timeout raise, get a framed
        # error, and close the connection.
        timeout = getattr(service, "request_timeout_s", 60.0) + 5.0

        # quiet default request logging; metrics live in /stats
        def log_message(self, fmt, *args):   # noqa: ARG002
            pass

        def _reply(self, code: int, payload: dict) -> None:
            # Keep-alive discipline: replying while request-body bytes are
            # still unread (404 on a POSTed path, 413 oversize, bad JSON
            # length) would desync the stream — the next
            # handle_one_request would parse body bytes as a request line.
            # Drain small remainders; close on big or unknowable ones.
            try:
                unread = (int(self.headers.get("Content-Length", "0")
                              or 0) - getattr(self, "_body_read", 0))
            except ValueError:
                unread = -1                 # unparseable: can't recover
            if unread > 0 and unread <= (1 << 20):
                try:
                    self.rfile.read(unread)
                except OSError:
                    self.close_connection = True
            elif unread:
                self.close_connection = True
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # one handler instance serves a whole keep-alive connection:
            # reset the per-request body counter or _reply would drain
            # against the PREVIOUS request's count and desync the stream
            self._body_read = 0
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "platform": service.device.type})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            self._body_read = 0      # see do_GET
            if self.path != "/v1/caption":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length < 0:
                    # rfile.read(-1) would read to EOF: a connection
                    # thread pinned until the client closes
                    self._reply(400, {"error": "negative Content-Length"})
                    return
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": f"body {length} B exceeds "
                                               f"{MAX_BODY_BYTES} B"})
                    return
                raw = self.rfile.read(length)
                self._body_read = length
                req = json.loads(raw or b"{}")
                captions = self._dispatch(req)
            except BatcherOverloaded as e:  # backpressure: shed load
                self._reply(503, {"error": str(e)})
            except FuturesTimeout:
                self._reply(504, {"error": "request timed out waiting "
                                           "for the device"})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:          # batch fn failure
                self._reply(500, {"error": str(e)})
            else:
                self._reply(200, {"captions": captions})

        def _dispatch(self, req: dict) -> list[str]:
            if "id" in req or "ids" in req:
                ids = [req["id"]] if "id" in req else req["ids"]
                return service.caption_ids([int(i) for i in ids])
            if "features" in req:
                return service.caption_features(req["features"])
            if "image_b64" in req or "images_b64" in req:
                blobs = ([req["image_b64"]] if "image_b64" in req
                         else req["images_b64"])
                return service.caption_image_bytes(
                    [base64.b64decode(b) for b in blobs])
            raise ValueError(
                "body needs one of: id/ids, features, image_b64/images_b64")

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib default listen backlog of 5 resets bursts of concurrent
    # connects long before the service is saturated
    request_queue_size = 512
    daemon_threads = True


def make_server(service: CaptionService, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind and return the server (``.serve_forever()`` to run;
    ``port=0`` picks a free port — see ``server.server_address``)."""
    return _Server((host, port), make_handler(service))
