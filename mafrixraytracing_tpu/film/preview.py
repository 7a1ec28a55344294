"""Live progressive preview — the array-output replacement for the
reference's only interactive surface: a GLFW/OpenGL window + ImGui image
refreshed with the accumulating film every frame
(`/root/reference/EngineCore/Core/Film.fs:38-92`, render-loop callback
`Scene/Scene.fs:331-333`).

A headless accelerator renderer has no place for a GL swapchain, so the equivalent here is:

- atomic PNG refresh: `LivePreview.update(film_bytes)` rewrites one PNG
  via rename, so any image viewer / file watcher polling it always sees a
  complete frame (the progressive analog of `Film.GetFrame` blitting);
- optional localhost HTTP viewer: `LivePreview(..., http_port=N)` serves
  an auto-refreshing page at http://127.0.0.1:N/ showing the latest frame
  from memory — open it in a browser while a long render runs.

Stdlib only (threading + http.server); no GUI dependency, works over SSH.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

_PAGE = b"""<!doctype html><html><head><title>mafrixraytracing preview</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;max-width:96vw;max-height:96vh}
</style></head><body><img id=f src=/frame.png>
<script>setInterval(()=>{f.src='/frame.png?'+Date.now()},500)</script>
</body></html>"""


class LivePreview:
    """Progressive-film sink. `update(png_bytes_or_image)` refreshes the
    on-disk PNG atomically and the in-memory frame the HTTP viewer serves.

    Accepts either encoded PNG bytes or an (H, W, 3) uint8 array (encoded
    here via film.image.encode_png)."""

    def __init__(self, path: str | os.PathLike | None = None,
                 http_port: int | None = None):
        self.path = Path(path) if path is not None else None
        self._png: bytes = b""
        self._lock = threading.Lock()
        self._server = None
        if http_port is not None:
            self._start_server(int(http_port))

    # --- sink ---------------------------------------------------------
    def update(self, frame) -> None:
        from mafrixraytracing_tpu.film.image import encode_png

        png = frame if isinstance(frame, (bytes, bytearray)) else encode_png(frame)
        with self._lock:
            self._png = bytes(png)
        if self.path is not None:
            tmp = self.path.with_suffix(".tmp.png")
            tmp.write_bytes(png)
            os.replace(tmp, self.path)  # atomic: viewers never see a torn file

    # --- HTTP viewer --------------------------------------------------
    def _start_server(self, port: int) -> None:
        import http.server

        preview = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path.startswith("/frame.png"):
                    with preview._lock:
                        body = preview._png
                    if not body:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)

            def log_message(self, *a):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None
