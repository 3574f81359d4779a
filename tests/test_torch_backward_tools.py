"""The measuring tools around K4's backward, on the CPU: the static SASS
counts (``kernels/sass.py``) on a hand-written listing, the bf16 bound that
``chip_smoke.py`` and ``compare_attention --backward`` hold the kernels to
(``attention.backward_bound``, ``attention.assert_backward_within``), the
cases both run, and ``trace_backward`` (the source's TRACE points are the
ones its phase tables read)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch import trace_backward
from eyegaze_tpu_torch.kernels import attention, build, sass

ROOT = Path(__file__).resolve().parent.parent

# A listing in cuobjdump's format: one kernel with a loop from 0x0020 to
# 0x0080 (five instructions, two of them tensor-core ones) and one without.
LISTING = """
        Function : _Z29attention_bwd_one_pass_kernelILi16EEvN2bw4ArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0030*/                   MUFU.EX2 R2, R3 ;
        /*0040*/                   FFMA R5, R6, R7, R5 ;
        /*0050*/              @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0060*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0070*/                   ISETP.GE.AND P0, PT, R0, 0x10, PT ;
        /*0080*/              @!P0 BRA 0x20 ;
        /*0090*/                   EXIT ;
        Function : _Z14other_kernelv
        /*0000*/                   EXIT ;
"""


def test_sass_functions_and_main_loop():
    code = sass.functions(LISTING, r"attention_bwd_(\w+?)_kernelILi(\d+)E")
    assert list(code) == ["attention_bwd_one_pass_kernelILi16E"]
    ins = code["attention_bwd_one_pass_kernelILi16E"]
    assert [op for _, op, _ in ins][:3] == ["MOV", "S2R", "HMMA"]
    body = sass.main_loop(ins)
    assert body == ["HMMA", "MUFU", "FFMA", "HGMMA", "IADD3", "ISETP", "BRA"]
    mix = sass.mix(body, 2)
    assert mix["tensor"] == 1.0 and mix["sfu"] == 0.5 and mix["fp32"] == 0.5
    assert mix["other"] == 1.5 and mix["total"] == 3.5


def test_sass_main_loop_without_tensor_cores_is_empty():
    ins = [(0x0, "FADD", " R0, R0, R1"), (0x10, "BRA", " 0x0")]
    assert sass.main_loop(ins) == []


class _Library:
    """A stand-in for a built attention library's loop-score entry."""

    def __init__(self, table):
        self.table = table

    def attention_backward_loop_scores(self, code, d):
        return self.table.get((code, d), -1)


@pytest.mark.parametrize("kind,d,scores", [("dq", 16, 1024), ("dq", 128, 1024),
                                           ("dkv", 64, 1024), ("dkv", 128, 512),
                                           ("one_pass", 16, 2048), ("one_pass_wgmma", 64, 1024)])
def test_loop_scores_follow_the_tiles(kind, d, scores):
    """``_loop_scores`` asks the library by the kernel's code (the order of
    BACKWARD_KERNELS) and refuses a kernel the library has no instance of;
    the scores here are the tiles of csrc/attention.cu, which the card's
    test holds the library to."""
    lib = _Library({(attention.BACKWARD_KERNELS.index(kind), d): scores})
    assert attention._loop_scores(lib, kind, d) == scores
    with pytest.raises(ValueError, match="no"):
        attention._loop_scores(lib, kind, 2 * d)


@pytest.mark.cuda
def test_library_loop_scores_are_the_tiles():
    """The built library's scores a warp handles per main-loop trip: 16 rows
    by the 64-key tile (dQ kernel), 16 keys by a query tile of 64, 32 at d =
    128 (dK/dV kernel), 16 keys by 128 queries (one-pass, d = 16) or 64
    (wgmma, d = 64); -1 at a head dim a one-pass kernel is not built for."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc to build the library")
    lib = attention._library()
    want = {("dq", d): 1024 for d in attention.HEAD_DIMS}
    want.update({("dkv", d): 512 if d == 128 else 1024 for d in attention.HEAD_DIMS})
    want.update({("one_pass", d): 2048 if d == 16 else -1 for d in attention.HEAD_DIMS})
    want.update({("one_pass_wgmma", d): 1024 if d == 64 else -1 for d in attention.HEAD_DIMS})
    got = {(kind, d): lib.attention_backward_loop_scores(attention.BACKWARD_KERNELS.index(kind), d)
           for kind, d in want}
    assert got == want


def _inputs(seed=0, shape=(1, 2, 64, 16), tk=48):
    r = np.random.default_rng(seed)
    q, g = (torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    k, v = (torch.from_numpy(r.normal(size=shape[:2] + (tk, shape[3])).astype(np.float32)).to(
        torch.bfloat16) for _ in range(2))
    o = attention.attention_reference(q, k, v, 0.25)
    lse = attention.attention_lse_reference(q, k, 0.25)
    return q, k, v, o, lse, g


def test_backward_bound_holds_the_twin_against_itself():
    q, k, v, o, lse, g = _inputs()
    want = attention.flash_attention_backward_reference(q, k, v, o, lse, g, 0.25)
    terms = attention.backward_bound(q, k, v, o, lse, g, 0.25)
    errs = attention.assert_backward_within("twin", want, want, terms)
    assert all(e["max_abs_err"] == 0 and e["share_of_bound"] == 0 for e in errs.values())


def test_backward_bound_refuses_a_gradient_off_by_more_than_it():
    q, k, v, o, lse, g = _inputs(1)
    want = attention.flash_attention_backward_reference(q, k, v, o, lse, g, 0.25)
    terms = attention.backward_bound(q, k, v, o, lse, g, 0.25)
    bound = 2 * attention.BF16_U * (terms[0][2] + want[2].float().abs())
    off = list(want)
    off[2] = (want[2].float() + 2 * bound).to(torch.bfloat16)  # dv off by twice its bound
    with pytest.raises(AssertionError, match="dv"):
        attention.assert_backward_within("off", off, want, terms)


def test_backward_cases_are_within_and_past_the_one_pass_reach():
    """Every case of BACKWARD_CASES has Tk within one cluster of 8 blocks of
    128 keys; BACKWARD_PAST_REACH is past it.  Every head dim has a case."""
    assert all(tk <= 8 * 128 for _, _, tk in attention.BACKWARD_CASES)
    assert attention.BACKWARD_PAST_REACH[2] > 8 * 128
    assert {shape[-1] for _, shape, _ in attention.BACKWARD_CASES} == set(attention.HEAD_DIMS)


def test_compare_attention_backward_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.compare_attention",
                        "--backward", "old.cu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def _trace_points(text: str, kernel: str) -> set:
    """(role, point) of each TRACE in the body of a kernel of the source."""
    import re

    start = text.index(f"\n{kernel}(")
    end = text.index("\n}\n", start)
    return {(int(r), int(k)) for r, k in
            re.findall(r"TRACE\([^;]*?, (\d), \w+, (\d+)\);", text[start:end])}


@pytest.mark.parametrize("path,kernel", [("one_pass", "attention_bwd_one_pass_kernel"),
                                         ("one_pass_wgmma",
                                          "attention_bwd_one_pass_wgmma_kernel")])
def test_trace_instruments_every_point_of_the_one_pass_kernel(path, kernel):
    """Each point a phase of ``trace_backward.PHASES`` reads is a TRACE of
    that role in the kernel, and the kernel has no other."""
    points = _trace_points((build.CSRC / "attention.cu").read_text(), kernel)
    read = {(role, k) for role, spec in enumerate(trace_backward.PHASES[path].values())
            for _, starts, end in spec for k in (*starts, end)}
    assert points == read


def test_trace_phases_from_stamps():
    spec = trace_backward.PHASES["one_pass"]["consumer"]
    stamps = np.zeros((trace_backward.TILES, trace_backward.POINTS), dtype=np.int64)
    stamps[0, :7] = [10, 30, 130, 140, 0, 0, 0]  # a tile stamped up to point 3
    stamps[1, :7] = [200, 210, 300, 305, 320, 400, 404]
    rows = trace_backward.phases(stamps, spec, 2)
    assert rows[0]["wait for data"] == 20 and rows[0]["scores"] == 100
    assert rows[0]["wait for freed"] is None and rows[0]["partial dQ"] is None  # no stamp 4, 5
    stamps[0, 4:6] = [150, 200]
    assert trace_backward.phases(stamps, spec, 1)[0]["partial dQ"] == 50
    assert rows[1] == {"wait for data": 10, "scores": 90, "dS barrier": 5, "wait for freed": 15,
                       "partial dQ": 80, "partial barrier": 4}


def test_trace_backward_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    r = subprocess.run([sys.executable, "-m", "eyegaze_tpu_torch.trace_backward"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
