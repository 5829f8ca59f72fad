"""The port's live HTTP viewer (cpugpupathtracing_tpu_torch/viewer.py):
the seven cases of tests/test_viewer.py on the port's Renderer (on the
CPU), and one that applies the same sequence of input and control
payloads to the JAX package's LiveViewer and the port's, without
rendering, and compares camera, settings, materials, objects, pause,
mouse state and accumulation count after each."""

import json
import urllib.error
import urllib.request

import pytest

from cpugpupathtracing_tpu_torch.config import (
    BuildOption,
    CameraConfig,
    DebugRenderMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.models import materials as tmat
from cpugpupathtracing_tpu_torch.models import mesh as tmesh
from cpugpupathtracing_tpu_torch.models import scene as tscene
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.utils import image as imagelib
from cpugpupathtracing_tpu_torch.viewer import CAMERA_SPEED, LiveViewer


def _scene(S, mat, mesh):
    """tests/test_viewer.py's scene, built with either package."""
    s = S.Scene()
    grey = s.add_material(mat.Material.diffuse((0.6, 0.6, 0.6)))
    light = s.add_material(mat.Material.light((1.0, 1.0, 1.0), 10.0))
    s.add_mesh("cube", mesh.cube(half=1.0), grey)
    li = s.add_sphere("light", (6.0, 8.0, 6.0), 3.0, light)
    s.mark_light(li)
    return s


def _renderer() -> Renderer:
    return Renderer(
        _scene(tscene, tmat, tmesh),
        camera=CameraConfig(pos=(0.0, 0.0, 6.0), aspect=2.0),
        config=RenderConfig(width=64, height=32, samples_per_frame=1),
        settings=RenderSettings(max_ray_depth=2),
        device="cpu",
    )


@pytest.fixture()
def viewer():
    r = _renderer()
    v = LiveViewer(r, port=0)  # ephemeral port
    v.start()
    yield v
    v.close()


def _get(v, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{v.port}{path}", timeout=10) as resp:
        return resp.status, resp.headers.get_content_type(), resp.read()


def _post(v, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{v.port}{path}",
        data=json.dumps(payload).encode(),
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_frame_and_stats_roundtrip(viewer, tmp_path):
    viewer.renderer.render_frame()
    viewer.publish()
    code, ctype, body = _get(viewer, "/frame.png")
    assert code == 200 and ctype == "image/png"
    p = tmp_path / "f.png"
    p.write_bytes(body)
    img = imagelib.read_png(str(p))
    assert img.shape == (32, 64, 4)
    assert img[..., :3].max() > 0  # the light is in frame

    code, ctype, body = _get(viewer, "/stats.json")
    stats = json.loads(body)
    assert stats["accumulated_frames"] == 1
    assert stats["traced_rays"] > 0

    code, ctype, body = _get(viewer, "/")
    assert code == 200 and b"frame.png" in body


def test_input_moves_reference_fly_camera(viewer):
    r = viewer.renderer
    r.render_frame()
    assert r.num_accumulated == 1
    p0 = r.camera.pos
    code, body = _post(viewer, "/input", {"key": "w", "dt": 0.5})
    assert code == 200 and body["ok"]
    # W: pos.z -= speed * dt (Main.cpp:114-118)
    assert r.camera.pos[2] == pytest.approx(p0[2] - CAMERA_SPEED * 0.5)
    # movement resets accumulation (Main.cpp:292-296)
    assert r.num_accumulated == 0
    _post(viewer, "/input", {"key": "shift", "dt": 0.25})
    assert r.camera.pos[1] == pytest.approx(p0[1] - CAMERA_SPEED * 0.25)
    code, body = _post(viewer, "/input", {"key": "q", "dt": 0.1})
    assert not body["ok"]


def test_control_panel_knobs(viewer):
    r = viewer.renderer
    code, body = _post(viewer, "/control", {"pause": True})
    assert body["ok"] and r.pause_rendering
    _post(viewer, "/control", {"toggle_pause": True})
    assert not r.pause_rendering
    _post(viewer, "/control", {"render_mode": "whitted"})
    assert r.settings.render_mode == RenderMode.WHITTED
    _post(viewer, "/control", {"debug_mode": "bvh_depth"})
    assert r.settings.debug_render_mode == DebugRenderMode.BVH_DEPTH
    _post(viewer, "/control", {"max_ray_depth": 7, "russian_roulette": False})
    assert r.settings.max_ray_depth == 7
    assert r.settings.russian_roulette is False
    code, body = _post(viewer, "/control", {"render_mode": "nope"})
    assert not body["ok"]


def test_scene_tree_editors(viewer):
    """Round-4 control-surface closure: the scene-tree editors
    (Main.cpp:859-933) over /control -- material, sphere, plane (via a
    renderer with one), and BVH rebuild with a heuristic choice."""
    r = viewer.renderer
    # material editor: partial update merges over the current material
    code, body = _post(viewer, "/control", {
        "set_material": {"index": 0, "albedo": [0.9, 0.1, 0.2],
                         "specular": 0.5}})
    assert body["ok"]
    m = r.scene.materials[0]
    assert m.albedo == (0.9, 0.1, 0.2) and m.specular == 0.5
    assert r.num_accumulated == 0  # material edit resets (Main.cpp:263-265)

    # sphere editor (object 1 is the light sphere)
    code, body = _post(viewer, "/control", {
        "set_sphere": {"index": 1, "center": [5.0, 7.0, 5.0],
                       "radius": 2.5}})
    assert body["ok"]
    assert r.scene.objects[1].sphere == ((5.0, 7.0, 5.0), 2.5)

    # BVH rebuild with a heuristic combo choice (Source/BVH.cpp:149-186)
    before = r.scene.objects[0].build_option
    code, body = _post(viewer, "/control", {
        "rebuild_bvh": {"index": 0, "build_option": "naive_split"}})
    assert body["ok"]
    assert r.scene.objects[0].build_option == BuildOption.NAIVE_SPLIT
    assert r.scene.objects[0].build_option != before or \
        before == BuildOption.NAIVE_SPLIT

    # malformed requests reject without crashing the server thread
    for bad in (
        {"set_material": {"index": 99, "albedo": [1, 1, 1]}},
        {"set_sphere": {"index": 0, "center": [0, 0, 0], "radius": 1.0}},
        {"rebuild_bvh": {"index": 0, "build_option": "nope"}},
        {"set_material": {"index": 0, "not_a_field": 1.0}},
    ):
        code, body = _post(viewer, "/control", bad)
        assert not body["ok"], bad
    # the server is still alive and serving
    code, _, _ = _get(viewer, "/stats.json")
    assert code == 200


def test_stats_include_per_object_bvh(viewer):
    """Per-object BVH stats in /stats.json (Source/BVH.cpp:149-186)."""
    viewer.renderer.render_frame()
    viewer.publish()
    _, _, body = _get(viewer, "/stats.json")
    stats = json.loads(body)
    objs = stats["objects"]
    assert objs[0]["kind"] == "mesh"
    bvh = objs[0]["bvh"]
    assert bvh["node_count"] >= 1 and bvh["max_depth"] >= 1
    assert bvh["triangles"] == 12  # the cube
    assert bvh["total_node_area"] > 0
    assert objs[1]["kind"] == "sphere" and objs[1]["is_light"]
    assert objs[1]["radius"] == 3.0


def test_mouse_input_and_capture(viewer):
    """The reference's mouse machinery (Input.cpp:64-84, Window.cpp:
    183-194, Main.cpp:279-290): deltas + capture are forwarded and
    surfaced in stats -- and, faithful to the reference, the camera
    IGNORES the deltas (Main.cpp:109 fetches mouse_move and never
    reads it)."""
    r = viewer.renderer
    cam_before = r.camera.pos
    code, body = _post(viewer, "/control", {"mouse_capture": True})
    assert body["ok"] and viewer.mouse_captured
    code, body = _post(viewer, "/input", {"mouse_dx": 12.0, "mouse_dy": -3.0})
    assert body["ok"]
    assert viewer.mouse_move_rel == (12.0, -3.0)
    assert r.camera.pos == cam_before  # the cannot-rotate quirk
    r.render_frame()
    viewer.publish()
    _, _, bstats = _get(viewer, "/stats.json")
    stats = json.loads(bstats)
    assert stats["input"]["mouse_move_rel"] == [12.0, -3.0]
    assert stats["input"]["mouse_captured"] is True
    # per-frame relative semantics: consumed by the snapshot
    assert viewer.mouse_move_rel == (0.0, 0.0)
    _post(viewer, "/control", {"mouse_capture": False})
    assert not viewer.mouse_captured


def test_serve_frames_bounded(viewer):
    viewer.serve_frames(2)
    assert viewer.renderer.num_accumulated == 2
    code, _, body = _get(viewer, "/frame.png")
    assert code == 200 and len(body) > 100


# every editor of apply_control and both kinds of input, good and bad
PAYLOADS = [
    ("input", {"key": "w", "dt": 0.5}),
    ("input", {"key": "shift", "dt": 0.25}),
    ("input", {"key": "a", "dt": 3.0}),
    ("input", {"key": "q", "dt": 0.1}),
    ("mouse", {"mouse_dx": 12.0, "mouse_dy": -3.0}),
    ("control", {"pause": True}),
    ("control", {"toggle_pause": True}),
    ("control", {"render_mode": "whitted"}),
    ("control", {"debug_mode": "bvh_depth"}),
    ("control", {"max_ray_depth": 7, "russian_roulette": False,
                 "next_event_estimation": 0}),
    ("control", {"render_mode": "nope"}),
    ("control", {"set_material": {"index": 0, "albedo": [0.9, 0.1, 0.2],
                                  "specular": 0.5, "is_light": 0}}),
    ("control", {"set_sphere": {"index": 1, "center": [5.0, 7.0, 5.0],
                                "radius": 2.5}}),
    ("control", {"set_plane": {"index": 1, "point": [0, 0, 0],
                               "normal": [0, 1, 0]}}),
    ("control", {"rebuild_bvh": {"index": 0,
                                 "build_option": "naive_split"}}),
    ("control", {"rebuild_bvh": {"index": 0, "build_option": "nope"}}),
    ("control", {"set_material": {"index": 99, "albedo": [1, 1, 1]}}),
    ("control", {"set_material": {"index": 0, "not_a_field": 1.0}}),
    ("control", {"mouse_capture": True}),
    ("control", {"render_mode": "advanced", "debug_mode": "none"}),
]


def _state(v) -> dict:
    """What a payload can change, as plain values of either package."""
    import dataclasses

    r = v.renderer

    def plain(x):
        return json.loads(json.dumps(dataclasses.asdict(x), default=int))

    return {
        "camera": plain(r.camera),
        "settings": plain(r.settings),
        "materials": [plain(m) for m in r.scene.materials],
        "objects": [(o.sphere, int(o.build_option)) for o in r.scene.objects],
        "paused": r.pause_rendering,
        "accumulated": r.num_accumulated,
        "mouse": (v.mouse_move_rel, v.mouse_captured),
    }


def test_payloads_match_jax_viewer():
    """The same payloads through the JAX package's LiveViewer and the
    port's (apply_input / apply_mouse / apply_control, no server, no
    frame): the same answers and the same state after each."""
    from cpugpupathtracing_tpu import viewer as jviewer
    from cpugpupathtracing_tpu.config import CameraConfig as JCameraConfig
    from cpugpupathtracing_tpu.config import RenderConfig as JRenderConfig
    from cpugpupathtracing_tpu.config import RenderSettings as JSettings
    from cpugpupathtracing_tpu.models import materials as jmat
    from cpugpupathtracing_tpu.models import mesh as jmesh
    from cpugpupathtracing_tpu.models import scene as jscene
    from cpugpupathtracing_tpu.models.renderer import Renderer as JRenderer

    j = jviewer.LiveViewer(JRenderer(
        _scene(jscene, jmat, jmesh),
        camera=JCameraConfig(pos=(0.0, 0.0, 6.0), aspect=2.0),
        config=JRenderConfig(width=64, height=32, samples_per_frame=1),
        settings=JSettings(max_ray_depth=2)), port=0)
    t = LiveViewer(_renderer(), port=0)
    for v in (j, t):
        v.start()  # the JAX package's close() waits for a started server
    try:
        for v in (j, t):
            v.renderer.num_accumulated = 3  # as if frames had run
        assert _state(j) == _state(t)
        for kind, payload in PAYLOADS:
            got = []
            for v in (j, t):
                if kind == "input":
                    got.append(v.apply_input(payload["key"], payload["dt"]))
                elif kind == "mouse":
                    got.append(v.apply_mouse(payload["mouse_dx"],
                                             payload["mouse_dy"]))
                else:
                    got.append(v.apply_control(json.loads(
                        json.dumps(payload))))
            assert got[0] == got[1], (payload, got)
            assert _state(j) == _state(t), payload
    finally:
        j.close()
        t.close()
