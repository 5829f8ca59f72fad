"""Live progressive viewer and interactive input over HTTP (the JAX
package's viewer.py over the port's Renderer; standard library only).

The stand-in for the reference's interactive surface: the Win32 window
and DX12 presenter (Source/Window.cpp:103-155, Source/DX12.cpp) and the
WASD/mouse fly camera of the main loop (Source/Main.cpp:104-131,
Source/Input.cpp:56-88).  A render host need not have a display, so the
progressive framebuffer is served as PNG over localhost HTTP and a small
HTML page polls it, overlays the stats panel (Main.cpp:841-857) and
forwards keyboard input back:

  GET  /            the viewer page (image + stats + key capture)
  GET  /frame.png   current progressive framebuffer (low-compression PNG)
  GET  /stats.json  the stats-panel numbers (Renderer.metrics()), with
                    the scene tree's per-object records: BVH node count,
                    max depth and total node area (Source/BVH.cpp:149-186)
  POST /input       {"key": "w|a|s|d|space|shift", "dt": seconds}: the
                    reference's fly-camera translation (Main.cpp:112-118:
                    W/S -> -/+z, A/D -> -/+x, Space/Shift -> +/-y, speed
                    2.0); any movement resets accumulation (Main.cpp:292).
                    {"mouse_dx": px, "mouse_dy": px}: relative mouse
                    movement (Input::UpdateMousePosition, Source/Input.cpp:
                    64-78), recorded and shown in /stats.json as
                    GetMouseMoveRel; the camera ignores it, as the
                    reference's does (Main.cpp:109 fetches mouse_move and
                    never reads it; the camera cannot rotate)
  POST /control     {"pause": bool} | {"toggle_pause": true} |
                    {"render_mode": name} | {"debug_mode": name} |
                    {"max_ray_depth": int, ...}: the ImGui panel's writable
                    knobs (Main.cpp:860-905); the scene-tree editors
                    (Main.cpp:859-933): {"set_material": {"index": i,
                    <Material fields to change>}} (Main.cpp:263-265),
                    {"set_sphere": {"index": obj, "center": [x,y,z],
                    "radius": r}} / {"set_plane": {"index": obj, "point":
                    [...], "normal": [...]}} (Source/Primitives.cpp:
                    385-415), {"rebuild_bvh": {"index": obj,
                    "build_option": "sah_split_intervals"|...}}
                    (Source/BVH.cpp:149-186); and {"mouse_capture": bool}
                    (Window::SetMouseCapture, Source/Window.cpp:183-194;
                    the page maps it to pointer lock)

The server runs on a daemon thread and never blocks the render loop: it
serves the latest published frame under a lock.  Rendering stays where
the caller drives it (cli --serve runs the frame loop on the main
thread, as the reference's Run() loop does), on whatever device the
renderer was made for.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    DebugRenderMode,
    RenderMode,
)
from cpugpupathtracing_tpu_torch.models.materials import Material
from cpugpupathtracing_tpu_torch.utils import image as imagelib
from cpugpupathtracing_tpu_torch.utils.log import log_info

# reference fly-camera speed (Main.cpp:160)
CAMERA_SPEED = 2.0

_KEY_DELTAS = {
    # Main.cpp:112-118: pos.x -= (A - D)*v; pos.y += (Space - Shift)*v;
    # pos.z -= (W - S)*v
    "a": (-1.0, 0.0, 0.0),
    "d": (1.0, 0.0, 0.0),
    "space": (0.0, 1.0, 0.0),
    "shift": (0.0, -1.0, 0.0),
    "w": (0.0, 0.0, -1.0),
    "s": (0.0, 0.0, 1.0),
}

_RENDER_MODES = {m.name.lower(): m for m in RenderMode}
_DEBUG_MODES = {m.name.lower(): m for m in DebugRenderMode}
_BUILD_OPTIONS = {m.name.lower(): m for m in BuildOption}
# Material edit surface: every per-material ImGui widget
# (Source/Main.cpp:256-266 -- albedo/specular/refractivity/absorption/
# ior/emissive/intensity/is_light); tuples arrive as 3-element lists
_MAT_FIELDS = {f.name: f.type for f in dataclasses.fields(Material)}

_PAGE = """<!doctype html>
<html><head><title>cpugpupathtracing-tpu</title><style>
body { background: #111; color: #ddd; font: 13px monospace; margin: 1em; }
#stats { white-space: pre; margin-top: .5em; }
img { image-rendering: pixelated; border: 1px solid #333; max-width: 100%; }
</style></head><body>
<div>WASD move &middot; Space/Shift up-down &middot; P pause (click the page first)</div>
<img id="frame" src="/frame.png">
<div id="stats"></div>
<script>
const img = document.getElementById("frame");
const stats = document.getElementById("stats");
let last = performance.now();
async function tick() {
  img.src = "/frame.png?t=" + Date.now();
  try {
    const r = await fetch("/stats.json");
    const s = await r.json();
    stats.textContent = JSON.stringify(s, null, 1);
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
window.addEventListener("keydown", async (e) => {
  const k = e.key === " " ? "space" : e.key.toLowerCase() === "shift" ? "shift" : e.key.toLowerCase();
  const now = performance.now(); const dt = Math.min((now - last) / 1000, 0.1); last = now;
  if ("wasd".includes(k) || k === "space" || k === "shift") {
    e.preventDefault();
    await fetch("/input", {method: "POST", body: JSON.stringify({key: k, dt: dt})});
  } else if (k === "p") {
    await fetch("/control", {method: "POST", body: JSON.stringify({toggle_pause: true})});
  }
});
// mouse capture via pointer lock: left-click captures, right-click /
// Esc releases (the reference main loop's toggles, Main.cpp:279-290)
img.addEventListener("click", () => img.requestPointerLock());
img.addEventListener("contextmenu", (e) => { e.preventDefault(); document.exitPointerLock(); });
document.addEventListener("pointerlockchange", () => {
  fetch("/control", {method: "POST", body: JSON.stringify(
    {mouse_capture: document.pointerLockElement === img})});
});
document.addEventListener("mousemove", (e) => {
  if (document.pointerLockElement !== img) return;
  fetch("/input", {method: "POST", body: JSON.stringify(
    {mouse_dx: e.movementX, mouse_dy: e.movementY})});
});
</script></body></html>"""


class LiveViewer:
    """Serve a Renderer's progressive state and accept input.

    The caller keeps driving renderer.render_frame(); call publish()
    after each frame (or let serve_frames do both)."""

    def __init__(self, renderer, host: str = "127.0.0.1", port: int = 8080):
        self.renderer = renderer
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._stats: dict = {}
        # mouse state (Input::Data, Source/Input.cpp:64-78 +
        # Window.cpp:183-194): relative move of the last input event
        # and the capture flag; the camera ignores the deltas exactly
        # like the reference (Main.cpp:109)
        self.mouse_move_rel = (0.0, 0.0)
        self.mouse_captured = False
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if not png:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                elif path == "/stats.json":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, "text/plain", b"bad json")
                    return
                if self.path == "/input":
                    if "mouse_dx" in payload or "mouse_dy" in payload:
                        ok = viewer.apply_mouse(
                            float(payload.get("mouse_dx", 0.0)),
                            float(payload.get("mouse_dy", 0.0)),
                        )
                    else:
                        ok = viewer.apply_input(
                            str(payload.get("key", "")),
                            float(payload.get("dt", 1.0 / 60.0)),
                        )
                    self._send(200 if ok else 400, "application/json",
                               json.dumps({"ok": ok}).encode())
                elif self.path == "/control":
                    ok = viewer.apply_control(payload)
                    self._send(200 if ok else 400, "application/json",
                               json.dumps({"ok": ok}).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    # -- lifecycle --

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread.start()
        log_info("Viewer", "live viewer at http://{}:{}/",
                 self._server.server_address[0], self.port)

    def close(self) -> None:
        """Stop the server (shutdown waits for a started serve loop only)."""
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    # -- render-loop integration --

    def publish(self) -> None:
        """Snapshot the renderer's current frame + stats (call after each
        render_frame; cheap: one RGBA copy + low-compression PNG)."""
        rgba = self.renderer.image_rgba8()
        png = imagelib.png_bytes(rgba, compress_level=1)
        stats = self.renderer.metrics()
        # the input panel's mouse readout (GetMouseMoveRel + capture
        # flag); per-frame relative semantics: reset after snapshot
        stats["input"] = {
            "mouse_move_rel": list(self.mouse_move_rel),
            "mouse_captured": self.mouse_captured,
        }
        self.mouse_move_rel = (0.0, 0.0)
        with self._lock:
            self._png = png
            self._stats = stats

    # -- input handlers (thread-safe wrt the render loop via simple
    #    attribute swaps; Renderer mutations are plain python state) --

    def apply_input(self, key: str, dt: float) -> bool:
        delta = _KEY_DELTAS.get(key)
        if delta is None:
            return False
        v = CAMERA_SPEED * max(0.0, min(dt, 1.0))
        self.renderer.move_camera((delta[0] * v, delta[1] * v, delta[2] * v))
        return True

    def apply_mouse(self, dx: float, dy: float) -> bool:
        """Record relative mouse movement (Input::UpdateMousePosition ->
        GetMouseMoveRel, Source/Input.cpp:64-84).  Faithful to the
        reference: the camera FETCHES this every frame and never uses
        it (Main.cpp:109; the screen-plane camera cannot rotate), so
        the deltas are tracked, surfaced in stats, and change nothing."""
        self.mouse_move_rel = (float(dx), float(dy))
        return True

    def set_mouse_capture(self, capture: bool) -> bool:
        """Window::SetMouseCapture (Source/Window.cpp:183-194): the
        page's pointer lock stands in for ShowCursor/ClipCursor."""
        self.mouse_captured = bool(capture)
        return True

    def apply_control(self, payload: dict) -> bool:
        r = self.renderer
        ok = False
        if payload.get("toggle_pause"):
            r.set_paused(not r.pause_rendering)
            ok = True
        if "pause" in payload:
            r.set_paused(bool(payload["pause"]))
            ok = True
        if "mouse_capture" in payload:
            ok = self.set_mouse_capture(bool(payload["mouse_capture"]))
        if "render_mode" in payload:
            mode = _RENDER_MODES.get(str(payload["render_mode"]).lower())
            if mode is None:
                return False
            r.set_render_mode(mode)
            ok = True
        if "debug_mode" in payload:
            mode = _DEBUG_MODES.get(str(payload["debug_mode"]).lower())
            if mode is None:
                return False
            r.set_debug_mode(mode)
            ok = True
        settings_keys = {
            "max_ray_depth": int,
            "next_event_estimation": bool,
            "cosine_weighted_diffuse": bool,
            "russian_roulette": bool,
        }
        updates = {
            k: conv(payload[k]) for k, conv in settings_keys.items()
            if k in payload
        }
        if updates:
            r.set_settings(r.settings.replace(**updates))
            ok = True

        # ---- scene-tree editors (Main.cpp:859-933) ----
        try:
            if "set_material" in payload:
                p = dict(payload["set_material"])
                idx = int(p.pop("index"))
                cur = r.scene.materials[idx]
                fields = {}
                for k, v in p.items():
                    if k not in _MAT_FIELDS:
                        return False
                    fields[k] = (
                        tuple(float(x) for x in v) if isinstance(v, list)
                        else (bool(v) if k == "is_light" else float(v))
                    )
                r.set_material(idx, dataclasses.replace(cur, **fields))
                ok = True
            if "set_sphere" in payload:
                p = payload["set_sphere"]
                r.set_sphere(
                    int(p["index"]),
                    tuple(float(x) for x in p["center"]),
                    float(p["radius"]),
                )
                ok = True
            if "set_plane" in payload:
                p = payload["set_plane"]
                r.set_plane(
                    int(p["index"]),
                    tuple(float(x) for x in p["point"]),
                    tuple(float(x) for x in p["normal"]),
                )
                ok = True
            if "rebuild_bvh" in payload:
                p = payload["rebuild_bvh"]
                opt = _BUILD_OPTIONS.get(
                    str(p.get("build_option", "")).lower())
                if opt is None:
                    return False
                r.rebuild_bvh(int(p["index"]), opt)
                ok = True
        except (KeyError, IndexError, TypeError, ValueError, RuntimeError):
            # bad index / wrong primitive kind / malformed payload: the
            # editors reject rather than crash the viewer thread
            return False
        return ok

    def serve_frames(self, frames: int | None = None) -> None:
        """Drive the render loop like the reference's Run() (Main.cpp:
        825-942): render, publish, repeat; paused frames publish stats
        only.  frames=None runs until KeyboardInterrupt."""
        i = 0
        try:
            while frames is None or i < frames:
                self.renderer.render_frame()
                self.publish()
                i += 1
        except KeyboardInterrupt:
            pass
