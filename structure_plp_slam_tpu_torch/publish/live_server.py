"""Live web map viewer: dependency-free HTTP server + polling page.

Port of structure_plp_slam_tpu/publish/live_server.py. Counterpart of the
reference's live viewing stack — the
socket_publisher streaming protobuf map diffs over socket.io to a node.js
server that renders them in the browser (reference:
src/socket_publisher/data_serializer.h:43-45, viewer/app.js). That stack
needs protobuf, socket.io-cpp and a node runtime; here a single
``ThreadingHTTPServer`` on a daemon thread serves

* ``/``        — the canvas orbiter page (publish/html_viewer.py) with a
                 500 ms polling loop, and
* ``/map.json`` — the current map snapshot (points, lines, planes,
                 keyframe frusta, trajectory, stats), assembled on demand
                 from the passive ``MapPublisher`` exactly the way the
                 reference's viewers poll its publishers
                 (publish/map_publisher.cc:80-160).

Snapshot assembly happens on the server thread per request; the SLAM loop
is never blocked. Consistency comes from immutability, not locking: the
system swaps its MapState reference atomically, so each request captures
ONE ``MapPublisher.snapshot()`` and derives every array from that single
capture (html_viewer.map_data), copying each tensor it reads to the host.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from structure_plp_slam_tpu_torch.publish import html_viewer


class LiveViewerServer:
    """Serve a live view of ``map_publisher`` on ``port`` (0 = ephemeral).

    Usage:
        srv = LiveViewerServer(slam.get_map_publisher())
        print(f"open http://localhost:{srv.port}")
        ...
        srv.stop()
    """

    def __init__(self, map_publisher, port: int = 0, max_points: int = 20000,
                 host: str = "127.0.0.1"):
        """``host`` defaults to loopback — the map is served
        unauthenticated, so exposing it beyond the machine (host=
        "0.0.0.0") must be an explicit choice."""
        self.map_publisher = map_publisher
        self.max_points = max_points
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                status = 200
                if self.path.split("?")[0] == "/map.json":
                    try:
                        data = html_viewer.map_data(
                            outer.map_publisher, outer.max_points
                        )
                        body = json.dumps(data).encode()
                    except Exception as e:  # pragma: no cover - defensive
                        # Non-200 so the polling client keeps its previous
                        # DATA instead of replacing it with this.
                        status = 503
                        body = json.dumps({"error": str(e)}).encode()
                    ctype = "application/json"
                else:
                    body = html_viewer.render_html(
                        html_viewer._EMPTY_DATA, live=True
                    ).encode()
                    ctype = "text/html; charset=utf-8"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
