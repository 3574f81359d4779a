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

Gradients: the head-packed entry point trains.  Where an input requires
grad it runs inside ``_HeadpackedAttention``, an autograd Function whose
forward is the kernel (the twin on the CPU) and whose backward,
``attention_backward_reference``, recomputes the standard attention gradient
in stock ops from the saved q, k and v: the JAX package's ``custom_vjp``
(``eyegaze_tpu/ops/attn_kernels.py::_headpacked_vjp_bwd``), which is einsum
outside any Pallas kernel.  ``backward_count`` counts its calls.  At ART's
training shape (16, 1024, 8, 16) one backward holds up to three (B, H, Tq,
Tk) f32 tensors, 512 MiB each, for the length of the call (PERF.md gives
the peak measured on the card).
The flash entry point has no backward (the JAX package calls the stock
Pallas kernel, whose backward no path of the port reaches): a CUDA input
that requires grad raises there.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from eyegaze_tpu_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype argument
DTYPES = tuple(_DTYPE_CODE)
_MAX_GRID_YZ = 65535  # heads and batch run on the grid's y and z axes

# Kernel launches since import (or since a caller reset them), by entry point;
# bf16_launch_count counts the launches of the bf16 instance among them.
launch_count = {"headpacked_attention": 0, "flash_attention": 0}
bf16_launch_count = {"headpacked_attention": 0, "flash_attention": 0}
# Calls of the head-packed entry point's backward, on any device.
backward_count = {"headpacked_attention": 0}


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


def bind(lib: ctypes.CDLL):
    """The C entry point ``attention_launch`` of a built attention library."""
    fn = lib.attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _library() -> ctypes.CDLL:
    return build.load("attention")


@functools.cache
def _launcher():
    return bind(_library())


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


def _launch(entry: str, q, k, v, scale: float, t_dim: int, h_dim: int):
    """Launch the kernel on the current stream; the output has q's strides."""
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    b, h, d = q.shape[0], q.shape[h_dim], q.shape[-1]
    tq, tk = q.shape[t_dim], k.shape[t_dim]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ or max(tq, tk) >= 2**31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)  # same strides as q: the caller's layout
    if out.numel() == 0:
        return out
    args = launch_args(q, k, v, out, scale, t_dim, h_dim)
    if q.device.index == torch.cuda.current_device():
        err = _launcher()(*args)
    else:  # the runtime launches on its current device
        with torch.cuda.device(q.device):
            err = _launcher()(*args)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    launch_count[entry] += 1
    if q.dtype == torch.bfloat16:
        bf16_launch_count[entry] += 1
    return out


def _headpacked_forward(qh, kh, vh, scale: float):
    if qh.device.type == "cpu":
        return attention_reference(*(x.transpose(1, 2) for x in (qh, kh, vh)),
                                   scale).transpose(1, 2)
    return _launch("headpacked_attention", qh, kh, vh, scale, t_dim=1, h_dim=2)


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _HeadpackedAttention(torch.autograd.Function):
    """The head-packed entry point under autograd: the kernel (the twin on
    the CPU) forward, ``attention_backward_reference`` backward."""

    @staticmethod
    def forward(ctx, qh, kh, vh, scale: float):
        ctx.save_for_backward(qh, kh, vh)
        ctx.scale = scale
        return _headpacked_forward(qh, kh, vh, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        backward_count["headpacked_attention"] += 1
        return (*attention_backward_reference(*ctx.saved_tensors, g, ctx.scale), None)


def headpacked_attention(qh, kh, vh, scale: float):
    """K3's counterpart: (B, Tq, H, d), (B, Tk, H, d) x2 -> (B, Tq, H, d).

    On a CUDA tensor this launches the kernel on the current stream; on a
    CPU tensor it runs the plain twin.  Any other device raises.  Where an
    input requires grad, the call goes through ``_HeadpackedAttention``.
    """
    _check(qh, kh, vh, t_dim=1)
    if _wants_grad(qh, kh, vh):
        return _HeadpackedAttention.apply(qh, kh, vh, scale)
    return _headpacked_forward(qh, kh, vh, scale)


def flash_attention(q, k, v, sm_scale: float):
    """K4's counterpart: (B, H, Tq, d), (B, H, Tk, d) x2 -> (B, H, Tq, d).

    On a CUDA tensor this launches the kernel on the current stream; on a
    CPU tensor it runs the plain twin.  Any other device raises, and so
    does a CUDA input that requires grad: this entry point has no backward.
    """
    _check(q, k, v, t_dim=2)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, sm_scale)
    if _wants_grad(q, k, v):
        raise RuntimeError("the flash entry point has no backward: run it under "
                           "torch.no_grad() / inference_mode(), or on the CPU")
    return _launch("flash_attention", q, k, v, sm_scale, t_dim=2, h_dim=1)
