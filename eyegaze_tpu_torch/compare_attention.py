"""Time the attention kernel's f32 instance, or K4's bf16 backward, against
other versions of its source, in one process on one CUDA card.

    git show <commit>:eyegaze_tpu_torch/csrc/attention.cu > .archive/old.cu
    python -m eyegaze_tpu_torch.compare_attention .archive/old.cu [other.cu ...]
    python -m eyegaze_tpu_torch.compare_attention --backward .archive/old.cu

Each other source is a version of ``csrc/attention.cu`` with the same C entry
point ``attention_launch`` (an earlier commit's, or a variant with another
tiling).  All are built at once with the port's nvcc flags, and their ptxas
lines for the f32 instances are printed.  At each shape below, each build is
held to the plain twin (``ATTN_F32_TOL``) and timed in turns with the
others: one call between CUDA events, and 20 calls replayed from a CUDA
graph (device time alone).  The shapes are ART's (B, 1024, 8, 16) at its
serving buckets B = 1, 8, 32, and d = 32, 64 and 128 at the work of B = 32.
The last line of stdout is one JSON object with the card and every time.
It needs a CUDA device.

With ``--backward`` it compares the C entry ``attention_backward_launch``
of each source instead (whichever path each picks at each shape): the
ptxas lines of the backward kernels, their main loop's instructions per
score from the SASS (``attention.backward_loop_mix``), and at each of
``attention.BACKWARD_CASES`` dq, dk and dv held to the plain twin within
its bf16 bound (``attention.assert_backward_within``), a bit-identity check
of two launches, and one call and 20 graph-replayed calls timed in turns
with the others and with the library's backward
(``aten._scaled_dot_product_flash_attention_backward``, a yardstick no
path of the port calls).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch.kernels import attention, build

SHAPES = ((1, 1024, 8, 16), (8, 1024, 8, 16), (32, 1024, 8, 16), (32, 1024, 4, 32),
          (32, 1024, 2, 64), (32, 1024, 1, 128))  # (B, T, H, d), head-packed
ATTN_F32_TOL = dict(rtol=1e-5, atol=1e-5)  # chip_smoke.py's kernel-vs-twin tolerance
GRAPH_CALLS = 20
ROUNDS = 10


def cuda_ms(fn, calls: int = 1) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def graph(fn, calls: int = GRAPH_CALLS) -> torch.cuda.CUDAGraph:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return g


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+", type=Path, help="other versions of attention.cu")
    parser.add_argument("--backward", action="store_true",
                        help="compare K4's bf16 backward instead of the f32 forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_attention needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False

    sources = {"this": build.CSRC / "attention.cu", **{str(s): s.resolve() for s in args.sources}}
    built = build.build_sources(sources)
    if args.backward:
        return backward_main(card, built)
    launchers = {}
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        f32 = False
        for line in report.splitlines():
            if "Compiling entry function" in line:
                f32 = "attention_kernel" in line and "bf16" not in line
                if f32:
                    print(f"  ptxas: {line.split('attention_kernel')[1].split('PK')[0]}")
            elif f32 and ("registers" in line or "spill" in line):
                print(f"    {line.strip()}")
        launchers[name] = attention.bind(ctypes.CDLL(str(lib)))

    device = torch.device("cuda", 0)
    result = {"card": card, "device": torch.cuda.get_device_name(0), "shapes": {}}
    for seed, shape in enumerate(SHAPES):
        r = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(device)
                   for _ in range(3))
        scale = 1.0 / math.sqrt(shape[-1])
        want = attention.attention_reference(*(x.transpose(1, 2) for x in (q, k, v)),
                                             scale).transpose(1, 2)
        outs, calls = {}, {}
        for name, fn in launchers.items():
            out = torch.empty_like(q)
            calls[name] = lambda fn=fn, out=out: _check_err(  # on the stream current at the call
                fn(*attention.launch_args(q, k, v, out, scale, t_dim=1, h_dim=2)))
            calls[name]()
            torch.cuda.synchronize()
            torch.testing.assert_close(out, want, **ATTN_F32_TOL)
            outs[name] = float((out - want).abs().max())
        graphs = {name: graph(call) for name, call in calls.items()}
        one = {name: [] for name in calls}
        replay = {name: [] for name in calls}
        for i in range(ROUNDS):  # in turns, the order reversed every other round
            names = list(calls) if i % 2 == 0 else list(calls)[::-1]
            for name in names:
                one[name].append(cuda_ms(calls[name]))
                replay[name].append(cuda_ms(graphs[name].replay) / GRAPH_CALLS)
        key = "x".join(map(str, shape))
        rows = {}
        if shape[-1] in (16, 32):
            rows["rows_per_thread"] = attention.f32_rows_per_thread(shape[0], shape[2], shape[1],
                                                                    shape[3])
        for name in calls:
            rows[name] = {"max_abs_err": outs[name], "ms": statistics.median(one[name]),
                          "graph_ms": statistics.median(replay[name])}
            print(f"{key} {name}: max |kernel - twin| {outs[name]:.3e}; one call "
                  f"{rows[name]['ms']:.4f} ms, graph {rows[name]['graph_ms']:.4f} ms "
                  f"(medians of {ROUNDS})")
        result["shapes"][key] = rows
        del q, k, v, want, graphs
    print(json.dumps(result))
    return result


def backward_main(card: str, built: dict) -> dict:
    """``--backward``: each built source's ``attention_backward_launch``
    against the twin, against itself (bit-identity) and against the
    others and the library's backward in time."""
    launchers = {}
    result = {"card": card, "device": torch.cuda.get_device_name(0), "sass": {}, "shapes": {}}
    for name, (lib, report) in built.items():
        print(f"{name}: {lib.name}")
        bwd = False
        for line in report.splitlines():
            if "Compiling entry function" in line:
                bwd = "attention_bwd" in line
                if bwd:
                    print(f"  ptxas: {line.split('attention_bwd')[1].split('PK')[0]}")
            elif bwd and ("registers" in line or "spill" in line):
                print(f"    {line.strip()}")
        mix = attention.backward_loop_mix(lib)
        for kernel, counts in mix.items():
            print(f"  main loop of {kernel}, instructions per score and thread (static SASS): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in counts.items()))
        result["sass"][name] = mix
        launchers[name] = attention.bind_backward(ctypes.CDLL(str(lib)))

    device = torch.device("cuda", 0)
    for seed, (entry, (b, tq, h, d), tk) in enumerate(attention.BACKWARD_CASES):
        flash = entry == "flash_attention"
        t_dim, h_dim = (2, 1) if flash else (1, 2)
        scale = 1.0 / math.sqrt(d)
        r = np.random.default_rng(40 + seed)
        q, k, v, g = (torch.from_numpy(r.normal(size=(b, t, h, d)).astype(np.float32)).to(
            device, torch.bfloat16) for t in (tq, tk, tk, tq))
        if flash:
            q, k, v, g = (a.transpose(1, 2).contiguous() for a in (q, k, v, g))

        def bhtd(a):
            return a if flash else a.transpose(1, 2)

        o, lse = attention._forward(entry, q, k, v, scale, t_dim, h_dim, with_lse=True)
        qt, kt, vt, ot, gt = (bhtd(a) for a in (q, k, v, o, g))
        want = attention.flash_attention_backward_reference(qt, kt, vt, ot, lse, gt, scale)
        terms = attention.backward_bound(qt, kt, vt, ot, lse, gt, scale)
        key = f"{entry} (B {b}, H {h}, Tq {tq}, Tk {tk}, d {d})"
        calls, rows = {}, {}
        for name, fn in launchers.items():
            outs = [tuple(torch.empty_like(a) for a in (q, k, v)) for _ in range(2)]

            def call(fn=fn, grads=outs[0]):  # on the stream current at the call
                _check_err(fn(*attention.backward_args(q, k, v, o, lse, g, *grads, scale,
                                                       t_dim, h_dim)))

            call()
            call(grads=outs[1])
            torch.cuda.synchronize()
            errs = attention.assert_backward_within(f"{key} {name}", [bhtd(a) for a in outs[0]],
                                                    want, terms)
            same = all(torch.equal(x, y) for x, y in zip(*outs))
            if not same:
                raise AssertionError(f"{key} {name}: two launches gave different bits")
            calls[name] = call
            rows[name] = {"errors": errs, "bit_equal_rerun": same}
        del want, terms
        lib = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False, False,
                                                                 scale=scale)

        def library():
            torch.ops.aten._scaled_dot_product_flash_attention_backward(
                gt, qt, kt, vt, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5], 0.0, False,
                lib[6], lib[7], scale=scale)

        calls["library"] = library
        graphs = {name: graph(call) for name, call in calls.items()}
        one = {name: [] for name in calls}
        replay = {name: [] for name in calls}
        for i in range(ROUNDS):  # in turns, the order reversed every other round
            names = list(calls) if i % 2 == 0 else list(calls)[::-1]
            for name in names:
                one[name].append(cuda_ms(calls[name]))
                replay[name].append(cuda_ms(graphs[name].replay) / GRAPH_CALLS)
        for name in calls:
            rows.setdefault(name, {}).update(ms=statistics.median(one[name]),
                                             graph_ms=statistics.median(replay[name]))
            err = ("" if name == "library" else "; max |kernels - twin| " + ", ".join(
                f"{k} {e['max_abs_err']:.3e} ({e['share_of_bound']:.2f} of its bound)"
                for k, e in rows[name]["errors"].items()))
            print(f"{key} {name}: one call {rows[name]['ms']:.4f} ms, graph "
                  f"{rows[name]['graph_ms']:.4f} ms (medians of {ROUNDS}){err}")
        result["shapes"][key] = rows
        del q, k, v, g, o, lse, lib, graphs
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


def _check_err(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")


if __name__ == "__main__":
    main()
