"""K3 and K4: softmax attention, one CUDA kernel for Hopper and its plain twin.

Replaces two Pallas TPU kernels that compute the same unmasked, bias-free,
non-causal attention ``softmax(q k^T * scale) v`` in two layouts:

- K3, ``eyegaze_tpu/ops/attn_kernels.py::headpacked_attention`` (pallas_call
  in ``_headpacked_fwd_impl``), on (B, T, H, d): here ``headpacked_attention``;
- K4, the stock ``jax.experimental.pallas.ops.tpu.flash_attention`` that
  ``eyegaze_tpu/models/transformer.py:232`` calls on (B, H, T, d): here
  ``flash_attention``, covering what that call uses (no ``ab``, no
  ``segment_ids``, ``causal=False``).

Both launch the one kernel of ``csrc/attention.cu`` with their layout's
strides, never with a transposed copy.  Numerics: f32 or bf16 operands;
scores, softmax and the PV sums in f32; probabilities rounded to the operand
type before PV; output in the operand type.

What bounds it on an H100: 4 * B * H * Tq * Tk * d matmul operations and
B * H * Tq * Tk exponentials (about 17 GFLOP and 268 M at ART's B = 32,
T = 1024, H = 8, d = 16) against only the bytes of Q, K, V and the output,
so operations, not device memory.  The f32 instance runs its FMAs on the
CUDA cores, each thread holding 4 query rows at d = 16 and 2 at d = 32 where
the grid still fills the card (``f32_rows_per_thread`` says which tiling a
call gets); the bf16 instance runs both products on the tensor cores
(``mma.sync``), and at d = 16 its exponentials, all on the SFU, take longer
than the products (the card's floor is lower: the FMA pipes could compute
part of them as a polynomial).  The plain twin instead writes and reads
the (B, H, Tq, Tk) f32 score tensor (1 GiB at that shape) several times.
All three times sit in PERF.md.  Both instances stage K and V rows with
16-byte copies.  A bf16 launch wants 16-byte aligned pointers and batch,
time and head strides that are multiples of 8 elements; every layout the
model's projections give has them, and the wrapper raises for the rest.  An
f32 launch whose K or V rows are not 16-byte aligned stages them element by
element instead.

A CPU tensor goes to the plain twin ``attention_reference``; a CUDA tensor
launches the kernel, or raises.  ``launch_count`` counts the kernel's
launches, one count for each entry point, and ``bf16_launch_count`` those of
them that ran the bf16 instance.

Gradients: both entry points train.  Where an input requires grad the call
runs inside an autograd Function, ``_HeadpackedAttention`` or
``_FlashAttention``.  In bf16 both take K4's backward, written by hand for
Hopper in the same source (``attention_backward_launch``): the forward
launches the kernel with its row log-sum-exp saved, and the backward, with P
recomputed from the log-sum-exp as the stock Pallas
``_flash_attention_bwd_dq`` and ``_flash_attention_bwd_dkv`` compute it (P
in f32, rounded to bf16 before dV, and dS rounded to bf16 before dK and
dQ), takes one of three paths by shape (``backward_path``): with up to 1024
keys, at d = 16 (ART's attention) and at d = 64, one kernel in one pass
over the scores, whose thread-block cluster sums dQ in a fixed order
(``mma.sync`` at d = 16, ``wgmma`` at d = 64); else two kernels, dQ (which
also writes ``Di = sum_d O dO``) and then dK/dV, FlashAttention-2's
backward.  ``flash_attention_backward_reference`` is their plain twin, and
``backward_bound`` / ``assert_backward_within`` the bf16 bound both are held
to against it.
The bf16 head-packed route takes that backward too: in the JAX package bf16
ART at attention dropout 0.0 trains its fused attention through the stock
flash kernel (``bench.py:477-499``), whose backward is the Pallas pair; the
port sends ART's d_k = 16 to the head-packed entry only for its layout, and
the kernel is one.  In f32 both keep the JAX ``custom_vjp``'s einsum
backward (``eyegaze_tpu/ops/attn_kernels.py::_headpacked_vjp_bwd``) in
stock ops, ``attention_backward_reference``, which at ART's training shape
(16, 1024, 8, 16) holds up to three (B, H, Tq, Tk) f32 tensors, 512 MiB
each, for the length of the call (PERF.md gives the peak measured on the
card).  On the CPU the Functions run the twins.  ``backward_count`` counts
the Functions' backward calls by entry point, ``backward_launch_count`` the
backward kernels' launches by path (one a call on the one-pass path, two on
the other), and ``stock_backward_count`` the calls that took
``attention_backward_reference``, by dtype: its bf16 count stays 0.
"""

from __future__ import annotations

import ctypes
import functools
import re

import torch
from torch.autograd.function import once_differentiable

from eyegaze_tpu_torch.kernels import build, sass

HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernel is instantiated for
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype argument
DTYPES = tuple(_DTYPE_CODE)
_MAX_GRID_YZ = 65535  # heads and batch run on the grid's y and z axes

# Kernel launches since import (or since a caller reset them), by entry point;
# bf16_launch_count counts the launches of the bf16 instance among them.
launch_count = {"headpacked_attention": 0, "flash_attention": 0}
bf16_launch_count = {"headpacked_attention": 0, "flash_attention": 0}
# Calls of each entry point's backward, on any device; launches of the
# backward kernels on CUDA by path (``backward_path``: up to 1024 keys a
# one-pass kernel, one launch a call, at d = 16 and, on wgmma, at d = 64;
# else the dQ and dK/dV kernels, two); calls that took the stock backward
# ``attention_backward_reference``, by dtype.
backward_count = {"headpacked_attention": 0, "flash_attention": 0}
backward_launch_count = {"one_pass": 0, "two_kernel": 0, "one_pass_wgmma": 0}
# Kernel launches a call, by path.
BACKWARD_LAUNCHES = {"one_pass": 1, "two_kernel": 2, "one_pass_wgmma": 1}
stock_backward_count = {"float32": 0, "bfloat16": 0}

# K4's backward at the shapes the port trains it at, (entry, (B, Tq, H, d),
# Tk): ART's training shape (batch 16 of 1024-sample windows, 8 heads of
# d_k 16), K4's flash shape, d = 32 and 64 at the same work, and ART's cross
# attention with a ragged Tk.  ``chip_smoke.py`` phase 3 and
# ``compare_attention --backward`` run these.
BACKWARD_CASES = (("headpacked_attention", (16, 1024, 8, 16), 1024),
                  ("flash_attention", (2, 1024, 8, 128), 1024),
                  ("headpacked_attention", (8, 1024, 8, 32), 1024),
                  ("headpacked_attention", (4, 1024, 8, 64), 1024),
                  ("headpacked_attention", (16, 1024, 8, 16), 1000))
# ART's training shape with a Tk past the one-pass kernel's reach (1024
# keys), where the backward takes the two-kernel path.
BACKWARD_PAST_REACH = ("headpacked_attention", (16, 1024, 8, 16), 2048)
# bf16's unit roundoff (8 significant bits).  The kernels and their twin
# both round P to bf16 before dV and dS before dK and dQ, each rounding
# moving a product by at most u of it, so a gradient entry differs by at
# most 2u T, T the sum of the |products| it adds; each rounds its result to
# bf16 once (2u |want| together); and the f32 parts (S, dP, Di summed in
# other orders, ex2.approx) stay under 2**-16 of F, the sums over the
# magnitudes whose difference dS is, where dP - Di cancels
# (``backward_bound``).
BF16_U = 2.0 ** -8
BWD_F32_SHARE = 2.0 ** -16


def attention_reference(q, k, v, scale: float):
    """Plain PyTorch twin on (B, H, Tq, d), (B, H, Tk, d) x2 -> (B, H, Tq, d).

    Matmul on operands upcast to f32, f32 softmax, P cast to the operand
    type, matmul with f32 accumulation, output cast to the operand type: the
    JAX einsum contract (``preferred_element_type=float32``).
    """
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_backward_reference(q, k, v, g, scale: float):
    """The gradient of ``headpacked_attention`` on (B, Tq, H, d), (B, Tk, H,
    d) x2 with output gradient ``g`` -> (dq, dk, dv), each in its input's
    dtype: the JAX ``_headpacked_vjp_bwd`` step for step.  Scores in f32
    from the operands, times ``scale``; the f32 softmax ``p``; ``dv = p^T
    g``; ``dp = g v^T``; ``ds = p (dp - sum(dp p)) scale``; ``dq = ds k``;
    ``dk = ds^T q``.  ``dp`` becomes ``ds`` in place, so at most three
    (B, H, Tq, Tk) f32 tensors are alive at once (p, ds and their product
    while it is summed)."""
    q32, k32, v32, g32 = (x.float().transpose(1, 2) for x in (q, k, v, g))  # (B, H, T, d)
    p = torch.softmax(torch.matmul(q32, k32.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    ds = torch.matmul(g32, v32.transpose(-1, -2))  # dp
    ds.sub_((ds * p).sum(dim=-1, keepdim=True)).mul_(p).mul_(scale)
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return tuple(d.transpose(1, 2).to(x.dtype) for d, x in ((dq, q), (dk, k), (dv, v)))


def attention_lse_reference(q, k, scale: float):
    """Each query row's log-sum-exp of its scaled scores, base 2, from
    (B, H, Tq, d), (B, H, Tk, d) -> (B, H, Tq) f32: ``log2 sum_j 2^(s_j
    scale log2(e))``, what the bf16 kernel saves for the backward."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.logsumexp(scores, dim=-1) * LOG2E


def flash_attention_backward_reference(q, k, v, o, lse, do, scale: float):
    """The plain twin of K4's backward kernels on (B, H, Tq, d), (B, H, Tk,
    d) x2, the output ``o``, its row log-sum-exp ``lse`` (B, H, Tq, base 2)
    and the output gradient ``do`` -> (dq, dk, dv) in the operands' dtype.

    The stock Pallas backward's arithmetic: S from the operands in f32,
    times ``scale``; P = 2^(S log2(e) - lse) in f32; ``Di = sum_d O dO`` in
    f32 from the output as the forward rounded it; dV = bf16(P)^T dO; dP = dO
    V^T; dS = (dP - Di) P scale; dK = bf16(dS)^T Q; dQ = bf16(dS) K; each sum
    in f32, each gradient rounded once to the operand type.  For f32
    operands the roundings are exact.
    """
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    p = torch.exp2(torch.matmul(q32, k32.transpose(-1, -2)) * (scale * LOG2E) - lse[..., None])
    di = (o.float() * do32).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), do32)
    ds = (torch.matmul(do32, v32.transpose(-1, -2)) - di) * p * scale
    del p
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_bound(q, k, v, o, lse, g, scale) -> tuple:
    """(B, H, T, d) f32 for dq, dk, dv: T, the sums of |products| each entry
    adds (|dS| |K|, |dS|^T |Q|, P^T |dO|), and F, the same sums over P
    (|dO| |V|^T + sum_d |O dO|) |scale|, the magnitudes whose difference dS
    is (none for dv)."""
    q, k, v, o, g = (x.float() for x in (q, k, v, o, g))
    p = torch.exp2(q @ k.transpose(-1, -2) * (scale * LOG2E) - lse[..., None])
    tv = p.transpose(-1, -2) @ g.abs()
    ds = ((g @ v.transpose(-1, -2)) - (o * g).sum(-1, keepdim=True)) * p * scale
    e = p * (g.abs() @ v.abs().transpose(-1, -2) + (o * g).abs().sum(-1, keepdim=True))
    del p
    e *= abs(scale)
    terms = (ds.abs() @ k.abs(), ds.abs().transpose(-1, -2) @ q.abs(), tv)
    del ds
    return terms, (e @ k.abs(), e.transpose(-1, -2) @ q.abs(), 0.0)


def assert_backward_within(name: str, got, want, bound_terms) -> dict:
    """dq, dk, dv of the kernels against the twin's within 2u T + 2u |want|
    + 2**-16 F (``backward_bound``, BF16_U); returns each one's largest
    |difference| and the share of its bound used."""
    out = {}
    for label, a, w, t, f in zip(("dq", "dk", "dv"), got, want, *bound_terms):
        w = w.float()
        err = (a.float() - w).abs()
        share = float((err / (2 * BF16_U * (t + w.abs()) + BWD_F32_SHARE * f)).max())
        out[label] = {"max_abs_err": float(err.max()), "share_of_bound": share}
        if not share <= 1.0:
            raise AssertionError(f"{name} {label} off by {float(err.max()):.3e}: {share:.2f}x "
                                 "its bf16 bound")
    return out


_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                    + [ctypes.c_float, ctypes.c_void_p])


def bind(lib: ctypes.CDLL):
    """The C entry point ``attention_launch`` of a built attention library."""
    fn = lib.attention_launch
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library() -> ctypes.CDLL:
    return build.load("attention")


@functools.cache
def _launcher():
    return bind(_library())


@functools.cache
def _lse_launcher():
    fn = _library().attention_lse_launch
    fn.argtypes = _LAUNCH_ARGTYPES + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_backward(lib: ctypes.CDLL):
    """The C entry point ``attention_backward_launch`` of a built attention
    library (K4's backward, whichever path the library picks)."""
    fn = lib.attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_launcher():
    return bind_backward(_library())


# The backward kernels, ``attention_bwd_<kind>_kernel<D>``, in the order of
# the codes the library's ``attention_backward_loop_scores`` takes.
BACKWARD_KERNELS = ("dq", "dkv", "one_pass", "one_pass_wgmma")
# ``attention_backward_path``'s codes.
_PATHS = {1: "one_pass", 2: "two_kernel", 3: "one_pass_wgmma"}


def _loop_scores(lib: ctypes.CDLL, kind: str, d: int) -> int:
    """Scores one warp handles in a trip of a backward kernel's main loop at
    head dim d, from the tiles the library was built with."""
    scores = lib.attention_backward_loop_scores(BACKWARD_KERNELS.index(kind), d)
    if scores <= 0:
        raise ValueError(f"no {kind} backward kernel at d = {d}")
    return scores


def backward_loop_mix(lib) -> dict:
    """Instructions per score and thread in the main loop of each backward
    kernel instance of a built library (``sass.CLASSES``, static SASS
    counts), by ``"<kind> d=<d>"``: the instructions of one trip over the
    scores each thread handles in it (a warp's scores over 32).  Empty for a
    library without ``attention_backward_loop_scores`` (an older source)."""
    loaded = ctypes.CDLL(str(lib))
    if not hasattr(loaded, "attention_backward_loop_scores"):
        return {}
    out = {}
    for name, ins in sass.functions(sass.dump(lib),
                                    r"attention_bwd_(\w+?)_kernelILi(\d+)E").items():
        kind, d = re.match(r"attention_bwd_(\w+?)_kernelILi(\d+)E", name).groups()
        out[f"{kind} d={d}"] = sass.mix(sass.main_loop(ins),
                                        _loop_scores(loaded, kind, int(d)) / 32)
    return dict(sorted(out.items()))


def backward_path(tk: int, d: int) -> str:
    """The path ``attention_backward_launch`` takes on the card for Tk keys
    at head dim d (the library's own choice, read from it): where one
    thread-block cluster covers the keys, ``"one_pass"`` (mma.sync, d = 16)
    or ``"one_pass_wgmma"``; else ``"two_kernel"``."""
    path = _PATHS.get(_library().attention_backward_path(tk, d))
    if path is None:
        raise ValueError(f"no backward path for Tk {tk}, d {d}")
    return path


def f32_rows_per_thread(b: int, h: int, tq: int, d: int) -> int:
    """Query rows per thread (1, 2 or 4) of the f32 instance for a call with
    batch ``b``, ``h`` heads, ``tq`` queries and head dim ``d`` on the
    current CUDA device: the launch's own choice, read from the library."""
    rows = _library().attention_f32_rows_per_thread(b, h, tq, d)
    if rows < 1:
        raise RuntimeError("attention_f32_rows_per_thread could not read the device")
    return rows


def _check(q, k, v, t_dim: int) -> None:
    for x in (q, k, v):
        if x.dim() != 4:
            raise ValueError(f"expected 4-d tensors, got shape {tuple(x.shape)}")
        if x.dtype not in DTYPES:
            raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
        if x.dtype != q.dtype:
            raise TypeError(f"dtype mismatch: {x.dtype} vs {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"device mismatch: {x.device} vs {q.device}")
        if x.stride(-1) != 1:
            raise ValueError("the head dim of every input must be contiguous (stride 1)")
    if k.shape != v.shape:
        raise ValueError(f"shape mismatch: k {tuple(k.shape)} vs v {tuple(v.shape)}")
    other = [a for a in range(4) if a != t_dim]
    if [q.shape[a] for a in other] != [k.shape[a] for a in other]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if k.shape[t_dim] == 0:
        raise ValueError("attention over zero keys is undefined")


def launch_args(q, k, v, out, scale: float, t_dim: int, h_dim: int) -> tuple:
    """``attention_launch``'s arguments for a call on the current stream with
    each tensor's own strides; raises for bf16 rows that are not 16-byte aligned."""
    ptrs = [x.data_ptr() for x in (q, k, v, out)]
    strides = [s[a] for s in (x.stride() for x in (q, k, v, out)) for a in (0, t_dim, h_dim)]
    if q.dtype == torch.bfloat16 and (any(s % 8 for s in strides) or any(p % 16 for p in ptrs)):
        raise ValueError("a bf16 launch wants 16-byte aligned rows: pointers aligned to "
                         "16 bytes and batch, time and head strides multiples of 8")
    return (*ptrs, _DTYPE_CODE[q.dtype], q.shape[0], q.shape[h_dim], q.shape[t_dim],
            k.shape[t_dim], q.shape[-1], *strides, scale,
            torch.cuda.current_stream(q.device).cuda_stream)


def _on_device(x, fn, *args) -> int:
    """``fn(*args)`` with x's device current: the runtime launches there."""
    if x.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(x.device):
        return fn(*args)


def _launch(entry: str, q, k, v, scale: float, t_dim: int, h_dim: int, with_lse: bool = False):
    """Launch the kernel on the current stream; the output has q's strides.
    With ``with_lse`` (bf16) also the rows' log-sum-exp, (B, H, Tq) f32."""
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    b, h, d = q.shape[0], q.shape[h_dim], q.shape[-1]
    tq, tk = q.shape[t_dim], k.shape[t_dim]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ or max(tq, tk) >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)  # same strides as q: the caller's layout
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    args = launch_args(q, k, v, out, scale, t_dim, h_dim)
    if with_lse:
        err = _on_device(q, _lse_launcher(), *args, lse.data_ptr())
    else:
        err = _on_device(q, _launcher(), *args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    launch_count[entry] += 1
    if q.dtype == torch.bfloat16:
        bf16_launch_count[entry] += 1
    return (out, lse) if with_lse else out


def backward_args(q, k, v, o, lse, g, dq, dk, dv, scale: float, t_dim: int,
                  h_dim: int) -> tuple:
    """``attention_backward_launch``'s arguments for a call on the current
    stream with each tensor's own strides (its f32 Di scratch allocated
    here); raises for rows that are not 16-byte aligned."""
    b, h, d = q.shape[0], q.shape[h_dim], q.shape[-1]
    tq, tk = q.shape[t_dim], k.shape[t_dim]
    di = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, g, dq, dk, dv)
    strides = [x.stride(a) for x in tensors for a in (0, t_dim, h_dim)]
    if any(s % 8 for s in strides) or any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("a bf16 launch wants 16-byte aligned rows: pointers aligned to "
                         "16 bytes and batch, time and head strides multiples of 8")
    ptrs = [x.data_ptr() for x in tensors]
    return (*ptrs[:5], lse.data_ptr(), di.data_ptr(), *ptrs[5:], b, h, tq, tk, d,
            (ctypes.c_longlong * 24)(*strides), scale,
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_backward(q, k, v, o, lse, g, scale: float, t_dim: int, h_dim: int):
    """K4's backward on the current stream: (dq, dk, dv), each with the
    strides of its input; counts the launches of the path it took."""
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"output gradient {g.dtype} {tuple(g.shape)} for an output "
                         f"{q.dtype} {tuple(q.shape)}")
    g = g.contiguous()  # autograd may pass a view, or an expanded (stride 0) gradient
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:  # no query row: no gradient reaches k or v
        return dq.zero_(), dk.zero_(), dv.zero_()
    path = backward_path(k.shape[t_dim], q.shape[-1])
    err = _on_device(q, _backward_launcher(),
                     *backward_args(q, k, v, o, lse, g, dq, dk, dv, scale, t_dim, h_dim))
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError {err}")
    backward_launch_count[path] += BACKWARD_LAUNCHES[path]
    return dq, dk, dv


def _bhtd(x, t_dim: int):
    """The (B, H, T, d) view of a tensor whose time axis is ``t_dim``, and
    back: the head-packed layout is its transpose."""
    return x.transpose(1, 2) if t_dim == 1 else x


def _forward(entry: str, q, k, v, scale: float, t_dim: int, h_dim: int,
             with_lse: bool = False):
    """The kernel on CUDA, the twins on the CPU (output, and with
    ``with_lse`` the rows' log-sum-exp)."""
    if q.device.type != "cpu":
        return _launch(entry, q, k, v, scale, t_dim, h_dim, with_lse)
    qt, kt, vt = (_bhtd(x, t_dim) for x in (q, k, v))
    out = _bhtd(attention_reference(qt, kt, vt, scale), t_dim)
    return (out, attention_lse_reference(qt, kt, scale)) if with_lse else out


def _backward(q, k, v, o, lse, g, scale: float, t_dim: int, h_dim: int):
    """K4's backward kernels on CUDA, their twin on the CPU."""
    if q.device.type != "cpu":
        return _launch_backward(q, k, v, o, lse, g, scale, t_dim, h_dim)
    grads = flash_attention_backward_reference(*(_bhtd(x, t_dim) for x in (q, k, v, o)), lse,
                                               _bhtd(g, t_dim), scale)
    return tuple(_bhtd(x, t_dim) for x in grads)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _function_forward(ctx, entry: str, q, k, v, scale: float, t_dim: int, h_dim: int):
    """The Functions' forward: in bf16 the kernel with the rows'
    log-sum-exp saved for K4's backward; in f32 the kernel alone."""
    ctx.entry, ctx.scale, ctx.dims = entry, scale, (t_dim, h_dim)
    if q.dtype == torch.bfloat16:
        out, lse = _forward(entry, q, k, v, scale, t_dim, h_dim, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
    else:
        out = _forward(entry, q, k, v, scale, t_dim, h_dim)
        ctx.save_for_backward(q, k, v)
    return out


def _function_backward(ctx, g):
    """The Functions' backward: K4's backward in bf16; in f32
    ``attention_backward_reference``, which takes the head-packed layout."""
    backward_count[ctx.entry] += 1
    t_dim, h_dim = ctx.dims
    saved = ctx.saved_tensors
    if len(saved) == 5:
        return (*_backward(*saved, g, ctx.scale, t_dim, h_dim), None)
    stock_backward_count[str(g.dtype).removeprefix("torch.")] += 1

    def bthd(x):
        return x.transpose(1, 2) if t_dim == 2 else x

    grads = attention_backward_reference(*(bthd(x) for x in saved), bthd(g), ctx.scale)
    return (*(bthd(x) for x in grads), None)


class _HeadpackedAttention(torch.autograd.Function):
    """The head-packed entry point under autograd: the kernel forward (the
    twin on the CPU); in bf16 K4's backward kernels (their twin on the CPU),
    in f32 ``attention_backward_reference``."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale: float):
        return _function_forward(ctx, "headpacked_attention", qh, kh, vh, scale, 1, 2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _function_backward(ctx, g)


class _FlashAttention(torch.autograd.Function):
    """The flash entry point under autograd, as ``_HeadpackedAttention`` on
    the (B, H, T, d) layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        return _function_forward(ctx, "flash_attention", q, k, v, scale, 2, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _function_backward(ctx, g)


def headpacked_attention(qh, kh, vh, scale: float):
    """K3's counterpart: (B, Tq, H, d), (B, Tk, H, d) x2 -> (B, Tq, H, d).

    On a CUDA tensor this launches the kernel on the current stream; on a
    CPU tensor it runs the plain twin.  Any other device raises.  Where an
    input requires grad, the call goes through ``_HeadpackedAttention``.
    """
    _check(qh, kh, vh, t_dim=1)
    if _wants_grad(qh, kh, vh):
        return _HeadpackedAttention.apply(qh, kh, vh, scale)
    return _forward("headpacked_attention", qh, kh, vh, scale, t_dim=1, h_dim=2)


def flash_attention(q, k, v, sm_scale: float):
    """K4's counterpart: (B, H, Tq, d), (B, H, Tk, d) x2 -> (B, H, Tq, d).

    On a CUDA tensor this launches the kernel on the current stream; on a
    CPU tensor it runs the plain twin.  Any other device raises.  Where an
    input requires grad, the call goes through ``_FlashAttention``, whose
    bf16 backward is K4's backward kernels.
    """
    _check(q, k, v, t_dim=2)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, sm_scale)
    return _forward("flash_attention", q, k, v, sm_scale, t_dim=2, h_dim=1)
