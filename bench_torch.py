"""Benchmark of the PyTorch/CUDA port: Mrays/s on the BASELINE.json
configurations (the port's counterpart of bench.py, with its arguments
and its JSON line).

Default = config 3: the reference default scene (glass dragon stand-in,
ground quad, two emissive spheres) at 1920x1080, ADVANCED (NEE, cosine
sampling, Russian roulette), depth 5, 1 spp a frame, progressive.  Rays
are counted as the reference's traced_rays counter counts them: one per
scene traversal of a lane, shadow rays included.  Prints ONE JSON line
with Mrays/s and vs_baseline against 100 Mrays/s.

    python bench_torch.py [width height [frames]] [--config N] [--spp K]
        [--devices N] [--shard-mode pixels|samples] [--device cuda|cpu]

On the card (the default device) the parity gates of
cpugpupathtracing_tpu_torch/parity_gate.py run after the timed span; a
failed gate raises and the run exits non-zero without a line.  With
--device cpu the wrappers run their plain versions and the gates' fields
are null.  --devices N renders over N ranks of a process group, one card
each:

    CPUGPU_DISTRIBUTED=1 torchrun --nproc-per-node N bench_torch.py \
        --devices N

pct_of_kernel_floor is null: the card has no measured floor yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from cpugpupathtracing_tpu_torch import parity_gate as pg
from cpugpupathtracing_tpu_torch.benchscenes import CONFIGS
from cpugpupathtracing_tpu_torch.config import RenderConfig
from cpugpupathtracing_tpu_torch.models import camera as camlib
from cpugpupathtracing_tpu_torch.models.renderer import Renderer
from cpugpupathtracing_tpu_torch.models.scene import pt_frame_gate_reason
from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
from cpugpupathtracing_tpu_torch.parallel import distributed, sharding
from cpugpupathtracing_tpu_torch.utils.device import resolve_device

BASELINE_MRAYS = 100.0


def apply_bench_flags() -> dict:
    """Apply the kernel flags of bench_flags.json at the repo root, else of
    the committed bench_flags_default.json, to the environment with
    setdefault (an explicit variable wins), and return them.  The port's
    config.packet_flags already defaults to these flags, and every scene
    build reads the environment, so applying them changes no table; they
    are applied and reported so that both benches name the same flags."""
    here = os.path.dirname(os.path.abspath(__file__))
    for fname in ("bench_flags.json", "bench_flags_default.json"):
        path = os.path.join(here, fname)
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        env = rec.get("env", {})
        for k, v in env.items():
            os.environ.setdefault(k, str(v))
        return env
    return {}


class _ShardedHookShim:
    """Stands in for the Renderer in a config's per-frame hook (config 5
    calls renderer.reset() after moving its instances); the sharded loop
    takes a new snapshot and zeroes the accumulator itself."""

    def __init__(self):
        self.want_reset = False

    def reset(self):
        self.want_reset = True


def _sync(device) -> None:
    """Wait for the queued work on `device` and raise on a kernel's error."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ptf.check_status(device)


def run_sharded(scene, cam, settings, width, height, frames, spp, seed,
                devices, shard_mode="pixels", hook=None, device="cuda"):
    """The --devices N bench body: `frames` progressive frames of the
    config through parallel/sharding.render_frame_sharded over the
    process group's N ranks (one rank: no group), after one frame outside
    the timed span.  `hook` is the config's per-frame edit (config 5: new
    instance transforms and a reset), run against a shim renderer: each
    hook is followed by a new snapshot (the refit) and, when it asked for
    a reset, a zeroed accumulator.  A frame takes spp samples a rank's
    lane slice (pixels) or spp samples a rank of the whole frame
    (samples), so the next frame's streams start past all of them.
    Returns (pixels u32 row-major on every rank, traced rays of all
    frames+1 frames, wall seconds of the timed frames)."""
    mesh = sharding.make_mesh(devices, device)
    shim = _ShardedHookShim()
    if hook is not None:
        hook(0, shim)
    ds = scene.device(mesh.device)
    cam_arr = camlib.to_arrays(cam, mesh.device)
    acc = torch.zeros(sharding.accumulator_shape(width, height, mesh.size,
                                                 shard_mode),
                      dtype=torch.float32, device=mesh.device)
    step = spp * (mesh.size if shard_mode == "samples" else 1)
    args = (settings, width, height, spp, seed, mesh, shard_mode)
    # the first frame outside the timed span, as the single-card path
    acc, pixels, traced, _ = sharding.render_frame_sharded(
        ds, cam_arr, acc, 0, *args)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        if hook is not None:
            shim.want_reset = False
            hook(f, shim)
            ds = scene.device(mesh.device)  # the refit snapshot
            if shim.want_reset:
                acc = torch.zeros_like(acc)
        # the traced counts add up on the device: one sync at the end
        acc, pixels, tr, _ = sharding.render_frame_sharded(
            ds, cam_arr, acc, f * step, *args)
        traced = traced + tr
    _sync(mesh.device)
    wall = time.perf_counter() - t0
    whole = sharding.gather_frame(pixels, width, height, shard_mode)
    return whole.astype("uint32"), int(traced), wall


def device_name(device) -> str:
    """The card's name with its index, or the device's own name."""
    if device.type != "cuda":
        return str(device)
    return f"{torch.cuda.get_device_name(device)} ({device})"


GATES = ("parity", "instanced", "whitted", "ptframe")


def run_gates(config: int, scene, settings, device) -> dict:
    """The parity gates bench.py runs, each gate's result by name (None
    where it does not run): the packet walk plain and instanced always,
    the Whitted kernel on config 1, the whole-frame kernel where this
    config's scene takes it.  A failed gate raises.  Configs 3 and 4
    render config 3's scene, so check_parity proves the tables just
    timed."""
    own = scene if config in (3, 4) else None
    res = dict.fromkeys(GATES)
    res["parity"] = pg.check_parity(scene=own, device=device)
    res["instanced"] = pg.check_parity_instanced(device=device)
    if config == 1:
        res["whitted"] = pg.check_parity_whitted(device=device)
    if pt_frame_gate_reason(scene.device(device), settings) is None:
        res["ptframe"] = pg.check_parity_ptframe(device=device)
    return res


def launches_since(before: dict) -> dict:
    """The kernel launches counted (ops/pt_frame.py launches) since the
    snapshot `before`, by arm."""
    return {k: v - before.get(k, 0) for k, v in ptf.launches.items()
            if v != before.get(k, 0)}


def detail(**kw) -> None:
    """One line of unrounded figures on stderr, beside the JSON line."""
    print("BENCH_DETAIL " + json.dumps(kw), file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("size", nargs="*", type=int, help="width height [frames]")
    p.add_argument("--config", type=int, default=3, choices=[1, 2, 3, 4, 5])
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--devices", type=int, default=0,
                   help="render over N ranks of a process group, one card "
                        "each (every config, config 5's refit included)")
    p.add_argument("--shard-mode", default="pixels",
                   choices=["pixels", "samples"],
                   help="--devices decomposition: lane slices (bitwise one "
                        "card's frames) or per-rank sample streams (spp x N "
                        "samples a frame)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda; cpu runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    flags_env = apply_bench_flags()
    args = parse_args(argv)

    name, factory = CONFIGS[args.config]
    t0 = time.perf_counter()
    scene, cam, settings, width, height, hook = factory()
    build_s = time.perf_counter() - t0

    frames = None  # sized from the warm frames' time
    if len(args.size) >= 2:
        width, height = args.size[0], args.size[1]
        cam = cam.replace(aspect=width / height)
    if len(args.size) >= 3:
        frames = args.size[2]

    if args.devices:
        distributed.maybe_initialize_distributed(device=args.device)
        cfg = RenderConfig(width=width, height=height,
                           samples_per_frame=args.spp)
        nframes = frames or 32
        before = dict(ptf.launches)
        _, traced, wall = run_sharded(
            scene, cam, settings, width, height, nframes, args.spp,
            cfg.seed, args.devices, shard_mode=args.shard_mode, hook=hook,
            device=args.device)
        # traced counts frames + 1 frames (the first one included) but the
        # wall clock times the last nframes: scale the rays to the span
        rays_timed = traced * nframes // (nframes + 1)
        mrays = rays_timed / wall / 1e6
        detail(mrays=mrays, frame_ms=wall / nframes * 1e3, traced=traced,
               scene_build_s=build_s, launches=launches_since(before))
        if distributed.is_primary():
            print(json.dumps({
                "metric": f"Mrays/sec {name} ({width}x{height}, "
                          f"{args.devices} devices)",
                "value": round(mrays, 2),
                "unit": "Mrays/s",
                "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
                "extra": {
                    "config": args.config,
                    "devices": args.devices,
                    "shard_mode": args.shard_mode,
                    "frames_timed": nframes,
                    "frame_ms": round(wall / nframes * 1000.0, 2),
                    "bench_flags": flags_env,
                },
            }), flush=True)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        return

    device = resolve_device(args.device)
    r = Renderer(
        scene, camera=cam,
        config=RenderConfig(width=width, height=height,
                            samples_per_frame=args.spp),
        settings=settings, device=device)

    t0 = time.perf_counter()
    if hook:
        hook(0, r)
    r.render_frame()  # the snapshot, the kernels' build and the first frame
    first_s = time.perf_counter() - t0

    tw = time.perf_counter()
    for _ in range(4):
        if hook:
            hook(0, r)
        r.render_frame(sync=False)
    _sync(device)
    warm_dt = (time.perf_counter() - tw) / 4
    if frames is None:
        # ~10 s of timed span
        frames = int(min(256, max(8, 10.0 / max(warm_dt, 1e-3))))

    before = dict(ptf.launches)
    t0 = time.perf_counter()
    if hook is None:
        # no per-frame host work: queue every frame, one sync at the end
        rays = r.render_pipelined(frames)
    else:
        # the hook's refit is queued too: the counts add up on the device
        tr = None
        for f in range(frames):
            hook(f + 1, r)
            t_dev = r.render_frame(sync=False)
            tr = t_dev if tr is None else tr + t_dev
        _sync(device)
        rays = int(tr)
    wall = time.perf_counter() - t0
    span = launches_since(before)

    gates = dict.fromkeys(GATES)
    if device.type == "cuda":
        gates = run_gates(args.config, scene, settings, device)
    ok = {k: None if v is None else v["ok"] for k, v in gates.items()}

    mrays = rays / wall / 1e6
    frame_ms = wall / frames * 1000.0
    detail(mrays=mrays, frame_ms=frame_ms, rays=rays, scene_build_s=build_s,
           first_frame_s=first_s, warm_frame_ms=warm_dt * 1e3,
           launches=span, gates=gates)
    print(json.dumps({
        "metric": f"Mrays/sec/chip {name} ({width}x{height}, spp {args.spp})",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "extra": {
            "config": args.config,
            # bench.py's floor is a TPU's cost per loop iteration times
            # its iteration census; the card has no measured floor yet
            "pct_of_kernel_floor": None,
            "frame_ms": round(frame_ms, 2),
            "rays_per_frame": rays // frames,
            "resolution": f"{width}x{height}",
            "frames_timed": frames,
            "scene_build_s": round(build_s, 1),
            "first_frame_s": round(first_s, 1),
            "compiled_parity_ok": ok["parity"],
            "compiled_parity_instanced_ok": ok["instanced"],
            "compiled_parity_whitted_ok": ok["whitted"],
            "compiled_parity_ptframe_ok": ok["ptframe"],
            "device": device_name(device),
            "bench_flags": flags_env,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
