"""L9, the shared-memory probe: the largest i32 table one block can hold
in shared memory on this card.

    python -m cpugpupathtracing_tpu_torch.labs.smem_probe [words ...]
    python -m cpugpupathtracing_tpu_torch.labs.smem_probe --device cpu

The port of the JAX package's tools/smem_probe.py (`probe` over _kernel,
an SMEM operand-size probe of the TPU).  On CUDA tensors `smem_probe`
launches the hand-written kernel of csrc/probes.cu (smem_probe_kernel;
built by ops/pt_frame.py with every unit): one block stages the table
into dynamic shared memory by asynchronous 16-byte copies (the table must
be 16-byte aligned) and returns tab[i * 8 + 3] (1-D) or tab[i][3] (the
(words / 8, 8) 2-D view).  On CPU tensors it runs the plain version,
the same read in PyTorch.  Nothing falls back from one to the other.

A table the device refuses to stage -- above its opt-in shared memory
per block, cudaDevAttrMaxSharedMemoryPerBlockOptin -- raises Refused:
that is the probe's answer.  `probe` turns it into FAIL only where the
table's bytes exceed that limit; any other error raises (a launch that
fails or reads a wrong value at a size that fits, a refusal of a size
that fits).

The driver probes the JAX driver's sizes (40,000, 160,000 and 260,000
words 1-D, 40,000 2-D), the limit's words and one word more, and the
entry mirrors (B x 8 words) of config 3's plain 64-col tree (2,980 rows)
and config 5's flattened tree (17,876 rows), reading the table's last row
(i = (words - 4) // 8); then a launch of a small table, which shows that a
refusal leaves no sticky error.  Per size: OK / FAIL, the device ms of
the launch (CUDA events with the stream held busy, common.busy_ms), the
profiler's ms of the kernel where it saw the launch, and its bound (the table's bytes read once
over 3.35 TB/s).  On the CPU there is no limit: the sizes beside the
H100's published 227 KB run the plain version.  The last line of the
output is a JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from cpugpupathtracing_tpu_torch.labs import common as cm
from cpugpupathtracing_tpu_torch.labs.launch_probe import (
    ProbeArgs,
    probes_lib,
)
from cpugpupathtracing_tpu_torch.utils.device import resolve_device

JAX_SIZES = ((40_000, False), (160_000, False), (260_000, False),
             (40_000, True))
# node rows of config 3's plain 64-col closest-hit tree and of config 5's
# flattened tree (PERF.md section 4): their (B, 8) entry mirrors
CONFIG3_ROWS, CONFIG5_ROWS = 2980, 17876
# the H100's opt-in shared memory per block (NVIDIA's data sheet): the
# CPU driver's stand-in for the device's attribute
H100_OPTIN_BYTES = 232_448
PEAK_BYTES_PER_S = 3.35e12
REFUSED = 1 << 16  # csrc/probes.cu's code for a refused table

_I32 = torch.int32


class Refused(RuntimeError):
    """The device refused to stage the table in shared memory."""


def smem_probe(tab: torch.Tensor, idx: torch.Tensor, *,
               two_d: bool = False) -> torch.Tensor:
    """(1,) i32: tab[idx * 8 + 3] of a (words,) i32 table (two_d: through
    the (words / 8, 8) view), the table staged in one block's shared
    memory on the card; raises Refused where the device will not stage
    it."""
    words = tab.numel()
    if (two_d and words % 8) or tab.dtype != _I32 or tab.dim() != 1 or \
            idx.shape != (1,):
        raise ValueError("smem_probe: a (words,) i32 table (whole rows of 8 "
                         "for the 2-D view) and a (1,) index")
    if tab.device.type == "cpu":
        return smem_probe_reference(tab, idx, two_d=two_d)
    if tab.device.type != "cuda":
        raise ValueError(f"smem_probe runs on cuda or cpu tensors, not "
                         f"{tab.device}")
    tab, idx = tab.contiguous(), idx.to(_I32).contiguous()
    if tab.data_ptr() % 16:
        raise ValueError("smem_probe: the kernel stages the table by 16-byte "
                         "copies; it must be 16-byte aligned")
    out = torch.empty(1, dtype=_I32, device=tab.device)
    a = ProbeArgs()
    a.inp, a.out, a.idx = tab.data_ptr(), out.data_ptr(), idx.data_ptr()
    a.stream = torch.cuda.current_stream(tab.device).cuda_stream
    a.n, a.two_d = words, int(two_d)
    rc = probes_lib().smem_probe_launch(ctypes.addressof(a))
    if rc & REFUSED:
        raise Refused(f"smem_probe: the device refused {words * 4} B of "
                      f"shared memory (error {rc & ~REFUSED})")
    if rc != 0:
        raise RuntimeError(f"smem_probe launch failed (error {rc})")
    cm.count_launch("smem_probe")
    return out


def smem_probe_reference(tab, idx, *, two_d=False):
    """The plain version: the same read in PyTorch."""
    if two_d:
        return tab.view(-1, 8)[idx.long(), 3].to(_I32)
    return tab[idx.long() * 8 + 3].to(_I32)


def optin_bytes(dev) -> int:
    """The device's opt-in shared memory per block (the H100's published
    figure for a CPU run)."""
    return cm.smem_optin() if dev.type == "cuda" else H100_OPTIN_BYTES


def sizes(optin: int) -> list:
    """(label, words, two_d) of every size the driver probes."""
    limit = optin // 4
    return ([(f"jax {w} {'2-D' if d else '1-D'}", w, d)
             for w, d in JAX_SIZES]
            + [("opt-in limit", limit, False),
               ("opt-in limit + 1 word", limit + 1, False),
               ("config 3 entry mirror", CONFIG3_ROWS * 8, False),
               ("config 5 entry mirror", CONFIG5_ROWS * 8, False)])


def probe(words: int, two_d: bool, dev, optin: int) -> dict:
    """One size, reading the last row: dict(words, bytes, two_d, fits,
    ok, value, expected).  ok False is the answer FAIL (a refused table
    above `optin` bytes); anything else that goes wrong raises."""
    tab = torch.arange(words, dtype=_I32, device=dev)
    idx = torch.full((1,), (words - 4) // 8, dtype=_I32, device=dev)
    expected = int(idx) * 8 + 3
    nbytes = words * 4
    fits = nbytes <= optin
    res = dict(words=words, bytes=nbytes, two_d=two_d, fits=fits,
               expected=expected)
    try:
        got = int(smem_probe(tab, idx, two_d=two_d))
    except Refused:
        if fits:
            raise
        return dict(res, ok=False, value=None)
    if not fits and dev.type == "cuda":
        raise AssertionError(f"smem_probe: {nbytes} B above the {optin} B "
                             "limit was staged")
    if got != expected:
        raise AssertionError(f"smem_probe: read {got} at row {int(idx)} of "
                             f"{words} words, want {expected}")
    return dict(res, ok=True, value=got)


def run(dev, words_list=None, timed: bool = False, reps: int = 5) -> list:
    """Every size (or the given words, 1-D), then a small table's launch
    after them (it must read its value: no refusal is sticky); where
    `timed`, each launched size's device ms (common.busy_ms over reps
    launches), the profiler's ms (None where it saw no launch) and bound
    (the table's bytes read once)."""
    optin = optin_bytes(dev)
    todo = sizes(optin) if not words_list else \
        [(f"{w} 1-D", w, False) for w in words_list]
    todo.append(("after the refusals", 1024, False))
    rows = [dict(probe(w, d, dev, optin), label=label)
            for label, w, d in todo]
    if timed:
        def launch(r):
            tab = torch.arange(r["words"], dtype=_I32, device=dev)
            idx = torch.full((1,), (r["words"] - 4) // 8, dtype=_I32,
                             device=dev)
            return lambda: smem_probe(tab, idx, two_d=r["two_d"])

        for r in (r for r in rows if r["ok"]):
            fn = launch(r)
            r["ms"] = cm.busy_ms(fn, reps)
            r["profiler_ms"] = cm.profiled_ms(fn, "smem_probe_kernel", reps)
            r["bound_ms"] = (r["bytes"] + 8) / PEAK_BYTES_PER_S * 1e3
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("words", type=int, nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    optin = optin_bytes(dev)
    rows = run(dev, args.words, timed=on_card)
    for r in rows:
        ms = f"  {r['ms']:.4f} ms" if "ms" in r else ""
        kb = r["bytes"] / 1024
        print(f"{r['label']:24s} {r['words']:>8d} words ({kb:.0f} KB, "
              f"{'2-D' if r['two_d'] else '1-D'}): "
              f"{'OK' if r['ok'] else 'FAIL'}{ms}", flush=True)
    print(json.dumps(dict(device=str(dev), optin_bytes=optin, sizes=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
