#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's main path -- config 3 (glass dragon stand-in, ground
quad, two sphere lights; ADVANCED, depth 5, 1 spp) at 1920x1080 through
`Renderer` -- and holds every CUDA kernel of that path against its plain
PyTorch version on the card.  Phases, one line each; any failure raises
and exits non-zero:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of the kernels from the checkout (seconds, ptxas)
  3. scene    the JAX-free config-3 scene build (seconds, table bytes)
  4. check    8192 lanes from the middle of the 1920x1080 blocked camera
              order through the kernel (single span, split span) and the
              plain version on the card; closest hits (t, id, object,
              normal) of the kernel's own traversal against brute force
  5. frame    one warm-up frame; one frame timing each kernel launch; one
              frame counting each launch's work and holding every 256th
              lane of both launches (their real inputs: 2 depths with the
              carry out, then 4 sorted depths with the carry in) against
              the plain version; then timed frames through Renderer
  6. the {"kernels": [...]} line: the 8192-lane check's numbers, and per
     main-path launch its lanes, ms, bound and sampled error
  7. the last line {"ok": true, "device": {...}}

--profile adds, after phase 5, a torch.profiler table of two frames'
device time by kernel and the device-busy share of the frame time.

Imports nothing of JAX and nothing of the JAX package.  Needs one card;
without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

CHECK_LANES = 8192
TIMED_FRAMES = 5
# every SAMPLE_STRIDE-th lane of a main-path launch is held against the
# plain version (~8100 lanes per launch at 1920x1080)
SAMPLE_STRIDE = 256
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations per unit of the kernel's work, counted from
# csrc/pt_device.cuh: one node row = 8 slab tests of 26 ops
# (push_children); one triangle test = 55 ops (tri_test); shading one
# path vertex ~300 ops (shade_surface with NEE sampling, ~20 divisions,
# ~8 square roots, 2 sin/cos pairs and 3 exp counted as one op each)
OPS_NODE = 8 * 26
OPS_TRI = 55
OPS_SHADE = 300
LEAF_TRIS, OCCL_TRIS = 8, 14
# bytes the kernel loads from one row (csrc/pt_device.cuh): a node row's
# 12 float4 of bounds and 2 of entries (push_children), a leaf row's 8
# records of 16 f32 (closest_hit), an occlusion leaf row's 14 of 9
# (any_hit)
NODE_ROW_BYTES = 14 * 16
LEAF_ROW_BYTES = LEAF_TRIS * 16 * 4
OCCL_ROW_BYTES = OCCL_TRIS * 9 * 4
# per-lane bytes of a launch: rays + RNG state in; the carry in
# (throughput, energy, flags); energy + state + traced out, or the whole
# carry out (rays, state, throughput, energy, flags, traced)
LANE_IN, CARRY_IN, LANE_OUT, CARRY_OUT = 32, 28, 24, 64
# megakernel contract (the JAX package's tests/test_megakernel.py)
FLIP_SHARE_MAX, FLIP_MAX, MEAN_MAX = 0.03, 0.02, 1e-4


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lane_bytes(carry_in: bool, carry_out: bool) -> int:
    return (LANE_IN + (CARRY_IN if carry_in else 0)
            + (CARRY_OUT if carry_out else LANE_OUT))


def bound_ms(iters: dict, lanes: int, lane_b: int, small_bytes: int):
    """Least time of one launch's work on this run's data: the larger of
    bytes over HBM bandwidth and f32 operations over the f32 peak.  The
    bytes are each lane's input read once and output written once, the
    small scene tables once, and once each table row the launch read
    (the distinct rows of pt_frame's count_iters), not whole tables.
    iters: pt_frame's count_iters counters by name (ptf.COUNTERS)."""
    c = iters
    ops = (OPS_NODE * (c["node"] + c["snode"])
           + OPS_TRI * LEAF_TRIS * c["leaf"]
           + OPS_TRI * OCCL_TRIS * c["sleaf"] + OPS_SHADE * c["ray"])
    rows = (NODE_ROW_BYTES * (c["node_rows"] + c["snode_rows"])
            + LEAF_ROW_BYTES * c["leaf_rows"]
            + OCCL_ROW_BYTES * c["sleaf_rows"])
    t_bytes = (lanes * lane_b + rows + small_bytes) / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def profile_frames(r, ms_per_frame: float, frames: int = 2) -> None:
    """Device kernel time by name over `frames` frames (torch.profiler),
    and the device-busy share of the unprofiled frame time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            r.render_frame(sync=False)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed themselves
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3 / frames, e.count // frames, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    say("profile", frames=frames, device_busy_ms_per_frame=busy,
        kernels_per_frame=sum(c for _, c, _ in rows),
        device_busy_share=busy / ms_per_frame)
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms/frame {count:5d}/frame  {key[:100]}",
              flush=True)


def plain(ptf, tables, rays, state, **kw):
    """pt_frame's plain version on the arguments of a pt_frame call."""
    keys = ("num_lights", "num_sph", "num_pln", "nee", "rr", "cosine",
            "ref_pdf", "depths", "light_tri_meta", "depth_base", "carry_in",
            "carry_out")
    return ptf.pt_frame_reference(tables[1], *tables[2:], rays, state,
                                  **{k: v for k, v in kw.items() if k in keys})


def contract(ref, got, what: str):
    """The megakernel contract on per-lane (N, 3) energies."""
    diff = (ref - got).abs()
    flips = (diff > 3e-6 + 3e-5 * ref.abs()).any(dim=1).float().mean().item()
    dmax = diff.max().item()
    dmean = abs(ref.mean().item() - got.mean().item())
    if not (flips < FLIP_SHARE_MAX and dmax < FLIP_MAX and dmean < MEAN_MAX):
        raise AssertionError(
            f"{what}: flip share {flips}, max {dmax}, mean {dmean} break the "
            "megakernel contract")
    return flips, dmax, dmean


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cpugpupathtracing_tpu_torch import benchscenes
    from cpugpupathtracing_tpu_torch.config import RenderConfig
    from cpugpupathtracing_tpu_torch.models import camera as camlib
    from cpugpupathtracing_tpu_torch.models import integrators
    from cpugpupathtracing_tpu_torch.models.renderer import Renderer
    from cpugpupathtracing_tpu_torch.ops import pt_frame as ptf
    from cpugpupathtracing_tpu_torch.utils import rng as rnglib

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = nvidia_smi()
    print(smi, flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    ptf.build()
    ptxas = [ln.strip() for ln in ptf.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=round(ptf.build_seconds, 2), source="csrc/pt_frame.cu")
    for ln in ptxas:
        print("  ptxas:", ln, flush=True)

    # 3. scene
    scene, cam_cfg, settings, width, height, _ = \
        benchscenes.config3_sah_dielectrics()
    t0 = time.perf_counter()
    ds = scene.device(dev)
    torch.cuda.synchronize()
    tb = ds.table_bytes()
    say("scene", seconds=round(time.perf_counter() - t0, 2),
        node_rows=ds.pnodes.shape[0], leaf_rows=ds.pltris.shape[0],
        occl_node_rows=ds.poccl_nodes.shape[0],
        occl_leaf_rows=ds.poccl_ltris.shape[0],
        table_bytes=sum(tb.values()),
        **{f"{k}_bytes": v for k, v in tb.items() if k.startswith("p")})
    small_bytes = sum(v for k, v in tb.items() if k.startswith("mk_"))

    # 4. kernel vs plain on 8192 lanes of the blocked camera order
    cam = camlib.to_arrays(cam_cfg, dev)
    n_all = width * height
    lo = n_all // 2 - CHECK_LANES // 2
    lane = torch.arange(lo, lo + CHECK_LANES, dtype=torch.int64, device=dev)
    bh, bw = camlib.block_shape(width, height)
    o, d, pix = camlib.blocked_lane_rays(cam, lane, width, height, bh, bw)
    st = rnglib.seed_lanes(pix, 0, salt=RenderConfig().seed)
    rays = tuple(o[:, k].contiguous() for k in range(3)) + tuple(
        d[:, k].contiguous() for k in range(3))
    kw = integrators.frame_kwargs(ds, settings)
    depths = settings.max_ray_depth + 1

    *out_k, it_k = ptf.pt_frame(*ds.tables(), rays, st, depths=depths,
                                count_iters=True, **kw)
    e_k, s_k, tr_k = out_k
    it_k = dict(zip(ptf.COUNTERS, (int(v) for v in it_k)))
    idx = torch.arange(CHECK_LANES, dtype=torch.int32, device=dev)
    s_sp, res_sp = integrators.trace_advanced_frame(ds, settings, o, d, st,
                                                    idx=idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e_p, s_p, tr_p = plain(ptf, ds.tables(), rays, st, depths=depths, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ptf.check_status(dev)
    split_same = bool(torch.equal(e_k, res_sp.energy)) and \
        int(tr_k) == int(res_sp.traced_rays)
    if not split_same:
        raise AssertionError("split-span kernel run differs from the single "
                             "span")
    if int(tr_k) != int(tr_p):
        raise AssertionError(f"traced: kernel {int(tr_k)} vs plain "
                             f"{int(tr_p)}")
    flips, dmax, dmean = contract(e_p, e_k, "kernel vs plain")
    hk = ptf.closest_hit(ds.pnodes, ds.pltris, ds.proots, rays)
    hp = ptf.closest_hit_reference(ds.pltris, rays)
    # t, triangle id, object and flat normal, compared as bits
    bad = torch.zeros_like(hk[1], dtype=torch.bool)
    for a_, b_ in zip(hk, hp):
        bad |= a_.view(torch.int32) != b_.view(torch.int32)
    mism = int(bad.sum())
    if mism:
        raise AssertionError(f"{mism} closest hits differ from brute force")
    kernel_ms = cuda_ms(lambda: ptf.pt_frame(*ds.tables(), rays, st,
                                             depths=depths, **kw), 20)
    b_ms, b_by = bound_ms(it_k, CHECK_LANES, lane_bytes(False, False),
                          small_bytes)
    say("check", lanes=CHECK_LANES, depths=depths, traced_kernel=int(tr_k),
        traced_plain=int(tr_p), traced_split=int(res_sp.traced_rays),
        split_bitwise=split_same, flip_share=flips, max_abs_err=dmax,
        mean_err=dmean, hit_mismatches=mism,
        hits=int((hk[1] >= 0).sum()), state_equal_share=float(
            (s_k == s_p).float().mean()),
        iters=it_k, kernel_ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)

    # 5. frame
    r = Renderer(scene, camera=cam_cfg,
                 config=RenderConfig(width=width, height=height),
                 settings=settings, device=dev)
    r.render_frame()  # warm-up
    entry = ptf.pt_frame

    def instrumented_frame(wrapped) -> None:
        ptf.pt_frame = wrapped
        try:
            r.render_frame()
        finally:
            ptf.pt_frame = entry
        torch.cuda.synchronize()

    # one frame with CUDA events around each launch
    events = []

    def timed(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = entry(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    instrumented_frame(timed)
    span_ms = [e0.elapsed_time(e1) for e0, e1 in events]

    # one frame counting each launch's work and keeping every
    # SAMPLE_STRIDE-th lane's inputs and energy for the plain version
    spans = []

    def counted(*a, **k):
        *out, iters = entry(*a, count_iters=True, **k)
        rays_, state_ = a[-2], a[-1]
        sel = torch.arange(0, state_.shape[0], SAMPLE_STRIDE, device=dev)
        ci = k.get("carry_in")
        energy_ = torch.stack(out[3], 1) if k.get("carry_out") else out[0]
        spans.append(dict(
            lanes=state_.shape[0], iters=iters, tables=a[:-2],
            rays=tuple(x[sel] for x in rays_), state=state_[sel],
            carry_in=None if ci is None else (
                tuple(x[sel] for x in ci[0]), tuple(x[sel] for x in ci[1]),
                ci[2][sel]),
            energy=energy_[sel], kw=k))
        return tuple(out)

    instrumented_frame(counted)
    if len(spans) != 2 or len(span_ms) != 2:
        raise AssertionError(f"{len(spans)} launches in a frame, expected 2")
    main_path = []
    for sp, ms in zip(spans, span_ms):
        k = dict(sp["kw"], carry_in=sp["carry_in"])
        res = plain(ptf, sp["tables"], sp["rays"], sp["state"], **k)
        e_ref = torch.stack(res[3], 1) if k.get("carry_out") else res[0]
        what = f"main-path launch {len(main_path) + 1}, sampled lanes"
        s_flips, s_max, s_mean = contract(e_ref, sp["energy"], what)
        it = dict(zip(ptf.COUNTERS, (int(v) for v in sp["iters"])))
        sb_ms, sb_by = bound_ms(
            it, sp["lanes"], lane_bytes(sp["carry_in"] is not None,
                                        bool(k.get("carry_out"))),
            small_bytes)
        main_path.append(dict(
            lanes=sp["lanes"], depths=k["depths"],
            depth_base=k.get("depth_base", 0), ms=ms, bound_ms=sb_ms,
            bound_by=sb_by, sampled_lanes=sp["state"].shape[0],
            max_abs_err=s_max, flip_share=s_flips, mean_err=s_mean,
            iters=it))
    ptf.check_status(dev)

    ptf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced = 0
    for _ in range(TIMED_FRAMES):
        traced = traced + r.render_frame(sync=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    traced = int(traced)
    launches = ptf.launches
    ptf.check_status(dev)
    if launches != 2 * TIMED_FRAMES:
        raise AssertionError(f"{launches} pt_frame launches in "
                             f"{TIMED_FRAMES} frames, expected 2 per frame")
    r.total_energy_received = 0.0
    r.num_accumulated = 0
    r.render_frame()
    energy = r.mean_energy
    img = r.image_u32()
    if not (math.isfinite(energy) and energy > 0.0):
        raise AssertionError(f"mean energy {energy}")
    if img.shape != (height, width) or not (img != 0xFF000000).any():
        raise AssertionError("the frame is black")
    say("frame", width=width, height=height, frames=TIMED_FRAMES,
        ms_per_frame=dt * 1e3 / TIMED_FRAMES,
        kernel_share=sum(span_ms) / (dt * 1e3 / TIMED_FRAMES),
        mrays_per_s=traced / dt / 1e6, traced_per_frame=traced // TIMED_FRAMES,
        launches_per_frame=launches / TIMED_FRAMES, mean_energy=energy)
    for k, mp in enumerate(main_path, 1):
        say(f"launch{k}", **mp)
    if "--profile" in sys.argv[1:]:
        profile_frames(r, dt * 1e3 / TIMED_FRAMES)

    # 6. kernels line: ms, plain_ms, bound_ms and max_abs_err of the
    # 8192-lane check (check_lanes); per main-path launch (main_path) its
    # lanes, ms, bound and the error of its sampled lanes
    print(json.dumps({"kernels": [{
        "name": "pt_frame",
        "route": "cuda",
        "source": "cpugpupathtracing_tpu_torch/csrc/pt_frame.cu",
        "replaces": "cpugpupathtracing_tpu/ops/pt_frame_kernel.py:419",
        "launches": launches,
        "max_abs_err": dmax,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "check_lanes": CHECK_LANES,
        "main_path": [{key: mp[key] for key in (
            "lanes", "depths", "ms", "bound_ms", "bound_by", "sampled_lanes",
            "max_abs_err")} for mp in main_path],
    }]}), flush=True)
    # 7. last line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
