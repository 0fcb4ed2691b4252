"""Live HTTP viewer (counterpart of ``ray_eater_tpu/io/viewer.py``): the
runtime analog of the reference's window/event loop (glfw.zig:58-104:
``Window``, ``shouldClose``, ``pollEvents``).

A headless card has no display, so "present" egresses over HTTP instead of
WSI: an MJPEG stream (multipart/x-mixed-replace) any browser or ``ffplay``
can show live, plus a single-frame endpoint and a minimal input channel
that feeds ``poll_events``/``should_close``, the three capabilities the
reference's glfw binding exposes. Standard library ``http.server`` and
threads; PIL is imported by :func:`encode_jpeg` alone, so the module
imports where PIL is missing.

Endpoints:

* ``/``        — HTML page: <img> bound to the stream + input-forwarding JS
* ``/stream``  — MJPEG: one JPEG part per presented frame
* ``/frame``   — latest frame as a single JPEG
* ``/input?key=K&action=down|up`` — key state (pollEvents analog)
* ``/input?mx=X&my=Y[&btn=B&action=..][&wheel=D]`` — mouse state: cursor
  in NORMALIZED [0,1] image coords, button downs, scroll-wheel deltas
  (glfwGetCursorPos / mouse-button / scroll callbacks; the reference
  forwards mouse through its pollEvents UBO, compute_drawing
  main.zig:326-331)
* ``/input?rw=W&rh=H`` — client viewport size: a RESIZE REQUEST the app
  may honor by rebuilding its swapchain (framebufferSizeCallback analog;
  the reference deferred resize, swapchain.zig:229-230)
* ``/close``   — request shutdown (window-close analog)

Typical loop (mirrors basic_planes.zig:316-350)::

    viewer = LiveViewer(port=8089)
    while not viewer.should_close:
        fb = frame(t)
        host = sc.present(fb)             # swapchain ring (u8 RGBA)
        if host is not None:
            viewer.present(host)
        keys = viewer.poll_events()
    viewer.stop()
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.logging import scoped

_log = scoped("viewer")


class MouseState(NamedTuple):
    """Cursor snapshot (glfwGetCursorPos + mouse-button + scroll analogs).
    ``x``/``y`` are NORMALIZED [0, 1] image coordinates (multiply by the
    framebuffer extent for pixels — the stream may be scaled client-side);
    ``buttons`` is the set of currently-held button indices (0 = left);
    ``wheel`` is the scroll delta accumulated since the last
    :meth:`LiveViewer.poll_mouse` (glfw scroll-callback semantics)."""
    x: float
    y: float
    buttons: frozenset
    wheel: float


_INDEX_HTML = b"""<!doctype html><html><head><title>ray_eater_tpu_torch</title>
<style>body{margin:0;background:#111;display:flex;justify-content:center}
img{image-rendering:pixelated;max-width:100vw;max-height:100vh}</style>
</head><body><img id="v" src="/stream" draggable="false">
<script>
const send=q=>fetch('/input?'+q);
const sk=(k,a)=>send(`key=${encodeURIComponent(k)}&action=${a}`);
window.addEventListener('keydown',e=>sk(e.key,'down'));
window.addEventListener('keyup',e=>sk(e.key,'up'));
window.addEventListener('beforeunload',()=>fetch('/close'));
const v=document.getElementById('v');
let mq=null;                       // pending mousemove, rAF-throttled
const norm=e=>{const r=v.getBoundingClientRect();
 return`mx=${((e.clientX-r.left)/r.width).toFixed(4)}`+
       `&my=${((e.clientY-r.top)/r.height).toFixed(4)}`};
v.addEventListener('mousemove',e=>{if(mq===null)
 requestAnimationFrame(()=>{send(mq);mq=null;});mq=norm(e);});
v.addEventListener('mousedown',e=>send(norm(e)+`&btn=${e.button}`+
 '&action=down'));
v.addEventListener('mouseup',e=>send(norm(e)+`&btn=${e.button}`+
 '&action=up'));
v.addEventListener('wheel',e=>{e.preventDefault();
 send(norm(e)+`&wheel=${e.deltaY.toFixed(1)}`);},{passive:false});
v.addEventListener('contextmenu',e=>e.preventDefault());
let rt=null;const rs=()=>send(`rw=${window.innerWidth}`+
 `&rh=${window.innerHeight}`);
window.addEventListener('resize',()=>{clearTimeout(rt);
 rt=setTimeout(rs,250);});
rs();
</script></body></html>"""

_BOUNDARY = b"rayeaterframe"


def encode_jpeg(frame: np.ndarray, quality: int = 85) -> bytes:
    """u8 RGB(A) array → JPEG bytes (PIL; alpha dropped)."""
    from PIL import Image
    arr = np.asarray(frame)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class LiveViewer:
    """Threaded MJPEG present target + event source.

    ``present`` is non-blocking: it swaps in the latest frame and wakes
    any connected stream clients (mailbox semantics — slow clients skip
    frames rather than backpressure the render loop, matching the
    swapchain ring's mailbox present mode, swapchain.zig:155-158).
    """

    def __init__(self, port: int = 8089, host: str = "0.0.0.0",
                 quality: int = 85):
        self._lock = threading.Condition()
        self._frame: bytes | None = None
        self._seq = 0
        self._keys: dict[str, bool] = {}
        self._mx = 0.5
        self._my = 0.5
        self._buttons: set = set()
        self._wheel = 0.0
        self._resize: tuple | None = None
        self._should_close = False
        self.quality = quality
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet access log
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    body = _INDEX_HTML
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/frame":
                    body = viewer._wait_frame(None)
                    if body is None:
                        self.send_response(503)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary="
                        + _BOUNDARY.decode())
                    self.end_headers()
                    last = -1
                    try:
                        while not viewer._should_close:
                            got = viewer._wait_frame(last, timeout=1.0)
                            if got is None:
                                continue
                            body, last = got, viewer._seq
                            self.wfile.write(
                                b"--" + _BOUNDARY + b"\r\n"
                                b"Content-Type: image/jpeg\r\n"
                                b"Content-Length: "
                                + str(len(body)).encode() + b"\r\n\r\n"
                                + body + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif url.path == "/input":
                    q = parse_qs(url.query)
                    key = q.get("key", [""])[0]
                    down = q.get("action", ["down"])[0] == "down"
                    with viewer._lock:
                        if key:
                            viewer._keys[key] = down
                        if "mx" in q:
                            try:
                                viewer._mx = float(q["mx"][0])
                                viewer._my = float(q.get("my", ["0"])[0])
                            except ValueError:
                                pass
                        if "btn" in q:
                            try:
                                b = int(q["btn"][0])
                                (viewer._buttons.add(b) if down
                                 else viewer._buttons.discard(b))
                            except ValueError:
                                pass
                        if "wheel" in q:
                            try:
                                viewer._wheel += float(q["wheel"][0])
                            except ValueError:
                                pass
                        if "rw" in q:
                            try:
                                viewer._resize = (int(q["rw"][0]),
                                                  int(q["rh"][0]))
                            except (ValueError, KeyError, IndexError):
                                pass
                    if key == "Escape" and down:
                        viewer._should_close = True
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif url.path == "/close":
                    viewer._should_close = True
                    with viewer._lock:
                        viewer._lock.notify_all()
                    self.send_response(204)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        _log.info("live viewer at http://%s:%d/", host, self.port)

    # -- present side -----------------------------------------------------
    def present(self, frame: np.ndarray) -> None:
        """Encode + publish the latest frame (u8 RGB/RGBA, HxWxC)."""
        body = encode_jpeg(frame, self.quality)
        with self._lock:
            self._frame = body
            self._seq += 1
            self._lock.notify_all()

    def _wait_frame(self, newer_than, timeout: float | None = None):
        with self._lock:
            if newer_than is None:
                return self._frame
            if self._seq == newer_than:
                self._lock.wait(timeout)
            if self._seq == newer_than:
                return None
            return self._frame

    # -- event side (glfw.pollEvents / shouldClose analogs) ---------------
    @property
    def should_close(self) -> bool:
        return self._should_close

    def poll_events(self) -> dict[str, bool]:
        """Snapshot of currently-down keys (glfw.zig pollEvents analog)."""
        with self._lock:
            return dict(self._keys)

    def poll_mouse(self) -> MouseState:
        """Cursor snapshot; the wheel accumulator resets on read (glfw
        scroll-callback semantics — deltas since the last poll)."""
        with self._lock:
            st = MouseState(self._mx, self._my,
                            frozenset(self._buttons), self._wheel)
            self._wheel = 0.0
            return st

    def poll_resize(self) -> tuple | None:
        """Latest client (width, height) resize request, or None; resets
        on read so each request is honored once
        (framebufferSizeCallback analog — swapchain.zig:229's deferred
        recreation, implemented here via ``Swapchain.resize``)."""
        with self._lock:
            r, self._resize = self._resize, None
            return r

    def request_close(self) -> None:
        self._should_close = True
        with self._lock:
            self._lock.notify_all()

    def stop(self) -> None:
        self.request_close()
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
