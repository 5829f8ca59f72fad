"""Command-line entry point (the JAX package's cli.py).

The reference has no CLI (its knobs are compile-time constants or ImGui
state); here every panel knob is a flag.  Renders N progressive frames of
a chosen scene on the card (--device cpu runs the plain PyTorch versions
of the kernels) and writes a PNG, printing the stats-panel numbers (FPS,
frame ms, traced rays, mean energy) per frame:

    python -m cpugpupathtracing_tpu_torch.cli --scene reference \
        --width 1280 --height 720 --frames 64 --out out.png

--checkpoint resumes from an .npz when it exists and saves to it at exit;
--serve PORT runs the live HTTP viewer (viewer.py).  Under a process
group (parallel/distributed.py: torchrun with CPUGPU_DISTRIBUTED=1, or
the CPUGPU_COORDINATOR variables) every rank renders its share of each
frame through parallel/sharding.py (pixels mode: the image is one card's
bitwise) and rank 0 writes the image; --serve and --checkpoint need one
process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cpugpupathtracing_tpu_torch.config import (
    CameraConfig,
    DebugRenderMode,
    DiffusePdfMode,
    RenderConfig,
    RenderMode,
    RenderSettings,
)
from cpugpupathtracing_tpu_torch.utils.log import log_info

MODES = {
    "comparison": RenderMode.COMPARISON,
    "bruteforce": RenderMode.BRUTE_FORCE,
    "advanced": RenderMode.ADVANCED,
    "whitted": RenderMode.WHITTED,
}
DEBUG_VIEWS = {
    "none": DebugRenderMode.NONE,
    "ray-depth": DebugRenderMode.RAY_DEPTH,
    "bvh-depth": DebugRenderMode.BVH_DEPTH,
}


def build_scene(name: str, gltf_path: str | None):
    from cpugpupathtracing_tpu_torch.models import gltf as gltflib
    from cpugpupathtracing_tpu_torch.models.scene import make_reference_scene
    from cpugpupathtracing_tpu_torch.models.whitted import make_whitted_scene

    if name == "reference":
        mesh = None
        if gltf_path:
            mesh = gltflib.load(gltf_path)
        return make_reference_scene(dragon_mesh=mesh)
    if name == "whitted":
        return make_whitted_scene()
    if name == "gltf":
        if not gltf_path:
            raise SystemExit("--gltf path required for --scene gltf")
        from cpugpupathtracing_tpu_torch.models import materials as matlib
        from cpugpupathtracing_tpu_torch.models.scene import Scene

        s = Scene()
        grey = s.add_material(matlib.Material.diffuse((0.7, 0.7, 0.7)))
        light = s.add_material(matlib.Material.light((1.0, 0.95, 0.8), 10.0))
        s.add_mesh("mesh", gltflib.load(gltf_path, apply_transforms=True),
                   grey)
        s.add_plane("floor", (0.0, -3.0, 0.0), (0.0, 1.0, 0.0), grey)
        li = s.add_sphere("light", (10.0, 10.0, 10.0), 5.0, light)
        s.mark_light(li)
        return s
    raise SystemExit(f"unknown scene '{name}'")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="wavefront path tracer (PyTorch/CUDA port)")
    p.add_argument("--scene", default="reference",
                   choices=["reference", "whitted", "gltf"])
    p.add_argument("--gltf", default=None,
                   help="glTF file for the mesh object")
    p.add_argument("--width", type=int, default=1280)  # Main.cpp:760
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--spp", type=int, default=1, help="samples per frame")
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--no-cosine", action="store_true")
    p.add_argument("--no-rr", action="store_true")
    p.add_argument("--correct-pdf", action="store_true",
                   help="use corrected diffuse pdfs instead of "
                        "reference-faithful")
    p.add_argument("--mode", default="advanced", choices=list(MODES))
    p.add_argument("--debug-view", default="none", choices=list(DEBUG_VIEWS))
    p.add_argument("--camera-pos", type=float, nargs=3,
                   default=[0.0, 0.0, 8.0])
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--seed", type=lambda x: int(x, 0), default=0x12345678)
    p.add_argument("--out", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="npz path: resume from it if present, save to it at "
                        "exit")
    p.add_argument("--stats-json", action="store_true",
                   help="print one JSON stats line per frame")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="start the live HTTP viewer (progressive frame + "
                        "stats + WASD fly camera) and render until "
                        "interrupted; --frames still bounds the loop if set")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the card; "
                        "'cpu' runs the plain PyTorch versions)")
    return p.parse_args(argv)


def frame_setup(args):
    """(scene, camera, config, settings) of the parsed flags."""
    settings = RenderSettings(
        max_ray_depth=args.max_depth,
        next_event_estimation=not args.no_nee,
        cosine_weighted_diffuse=not args.no_cosine,
        russian_roulette=not args.no_rr,
        render_mode=MODES[args.mode],
        debug_render_mode=DEBUG_VIEWS[args.debug_view],
        diffuse_pdf_mode=(DiffusePdfMode.CORRECT if args.correct_pdf
                          else DiffusePdfMode.REFERENCE),
    )
    camera = CameraConfig(pos=tuple(args.camera_pos), fov_deg=args.fov,
                          aspect=args.width / args.height)
    config = RenderConfig(width=args.width, height=args.height,
                          samples_per_frame=args.spp, seed=args.seed)
    return build_scene(args.scene, args.gltf), camera, config, settings


def build_renderer(args):
    """The Renderer of the parsed flags, on --device."""
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer

    scene, camera, config, settings = frame_setup(args)
    return Renderer(scene, camera=camera, config=config, settings=settings,
                    device=args.device)


def stats_line(frame: int, fps: float, frame_ms: float, traced: int,
               accumulated: int, mean_energy: float) -> str:
    """One --stats-json line, the JAX package's keys."""
    return json.dumps({
        "frame": frame,
        "fps": round(fps, 2),
        "frame_ms": round(frame_ms, 2),
        "traced_rays": traced,
        "accumulated": accumulated,
        "mean_energy": round(mean_energy, 4),
    })


def main_sharded(args) -> None:
    """One rank of a process group: every frame through
    render_frame_sharded in pixels mode; rank 0 prints the stats and
    writes the image.  The frames queue without a host sync; under
    --stats-json each frame syncs and all-reduces its energy sum for its
    line (the mean energy Renderer.mean_energy counts)."""
    import torch
    import torch.distributed as dist

    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.parallel import distributed, sharding
    from cpugpupathtracing_tpu_torch.utils import image as imagelib

    if args.serve is not None or args.checkpoint:
        raise SystemExit("--serve and --checkpoint run in one process")
    if args.frames < 1:
        raise SystemExit("--frames must be at least 1 under a process group")
    scene, camera, config, settings = frame_setup(args)
    mesh = sharding.make_mesh()
    w, h, spp = config.width, config.height, args.spp
    sharding.check_frame(w, h, mesh.size, settings, "pixels")
    ds = scene.device(mesh.device)
    cam = camlib.to_arrays(camera, mesh.device)
    acc = torch.zeros(sharding.accumulator_shape(w, h, mesh.size, "pixels"),
                      dtype=torch.float32, device=mesh.device)
    primary = distributed.is_primary()
    total_energy = 0.0
    for i in range(args.frames):
        t0 = time.perf_counter()
        acc, pixels, traced, energy_sum = sharding.render_frame_sharded(
            ds, cam, acc, i * spp, settings, w, h, spp, args.seed, mesh)
        if args.stats_json:
            dist.all_reduce(energy_sum)
            traced = int(traced)
            total_energy += float(energy_sum)
            dt = time.perf_counter() - t0
            accumulated = (i + 1) * spp
            if primary:
                print(stats_line(i, 1.0 / dt if dt > 0 else 0.0, dt * 1e3,
                                 traced, accumulated,
                                 total_energy / accumulated), flush=True)
    whole = sharding.gather_frame(pixels, w, h, "pixels")
    ptf.check_status(mesh.device)
    if primary:
        imagelib.write_png(args.out, imagelib.packed_to_rgba8(
            whole.astype("uint32").reshape(h, w)))
        print(f"wrote {args.out} ({args.frames * spp} accumulated "
              f"samples/pixel over {mesh.size} ranks)", file=sys.stderr)


def main(argv=None) -> None:
    args = parse_args(argv)

    from cpugpupathtracing_tpu_torch.parallel import distributed

    if distributed.maybe_initialize_distributed(device=args.device):
        main_sharded(args)
        return

    t0 = time.perf_counter()
    r = build_renderer(args)
    r.scene.device(r.device)
    log_info("cli", "scene ready in {:.3f} s", time.perf_counter() - t0)
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)

    if args.serve is not None:
        from cpugpupathtracing_tpu_torch.viewer import LiveViewer

        viewer = LiveViewer(r, port=args.serve)
        viewer.start()
        viewer.serve_frames(args.frames if args.frames > 0 else None)
        r.save_png(args.out)
        print(f"wrote {args.out} ({r.num_accumulated} accumulated "
              "samples/pixel)", file=sys.stderr)
        viewer.close()
        return

    for i in range(args.frames):
        r.render_frame()
        if args.stats_json:
            print(stats_line(i, r.stats.fps, r.stats.frame_time_ms,
                             r.stats.traced_rays, r.num_accumulated,
                             r.mean_energy), flush=True)
        else:
            print(f"frame {i + 1}/{args.frames}: "
                  f"{r.stats.frame_time_ms:.1f} ms, {r.stats.traced_rays} "
                  f"rays, mean energy {r.mean_energy:.3f}", file=sys.stderr)

    r.save_png(args.out)
    print(f"wrote {args.out} ({r.num_accumulated} accumulated "
          "samples/pixel)", file=sys.stderr)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
