"""K4's backward in the PyTorch port: the plain twin against the JAX
package's references, the autograd Functions on the CPU, and the CUDA
kernels against the twin on the card.

- ``flash_attention_backward_reference`` (the twin) against the installed
  jax's own plain flash backward, ``mha_reference_bwd``, given the residuals
  ``l`` and ``m`` of ``mha_reference_no_custom_vjp(..., save_residuals=True)``
  computed from the operands' f32 values.  ``mha_reference_bwd`` takes
  ``sm_scale=1.0`` only, so the scale, a power of two, is folded into q (exact
  in bf16 too) and dq rescaled.  f32: 1e-5 of each gradient's largest
  |entry|.  bf16: the twin rounds P to bf16 before dV and dS before dK and
  dQ, as the Pallas kernels do, and the reference does not: with u = 2**-8,
  bf16's unit roundoff, each rounding moves a product by at most u of its
  |value|, so a gradient moves by at most u T, T the sum of the |products|
  it adds (``_rounding_terms``), and the two roundings of the result to
  bf16 by at most 2u of it.
- The twin against ``jax.vjp`` of the JAX ``headpacked_attention`` in
  interpret mode (its ``custom_vjp``'s einsum backward), bf16: the same
  bound plus the rounding of Di.  The custom_vjp computes Di = sum_k dP P
  from the f32 P; the flash backward computes Di = sum_d O dO from the bf16
  output, which differs from the exact output by at most u (sum_k P |V| +
  |O|) per entry.  The test records that the two Di differ.
- ``_FlashAttention`` and ``_HeadpackedAttention`` on the CPU: in bf16 the
  forward is the twin and the gradients are the twin backward, exactly, and
  the counters move; in f32 the head-packed Function still takes
  ``attention_backward_reference``.
- On the card (``cuda`` marker; jax is imported only inside the CPU tests):
  the kernels' dq, dk, dv and the forward's log-sum-exp against the twin,
  both layouts, every head dim, ragged Tq and Tk, negative scales, the flash
  route's transposed views and an expanded output gradient, on every path
  (up to ONE_PASS_MAX_KEYS keys the one-pass kernel on mma.sync at d = 16
  and on wgmma at d = 64; the dQ and dK/dV kernels past it and at d = 32
  and 128); both sides round P and dS, so 2u T + 2u |want|.  Two backward
  passes give the same bits, at ART's, K4's and a d = 64 shape too.
- The source sums no gradient with atomics (a CPU check of the text).

    python -m pytest tests/test_torch_attention_backward.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch.kernels import attention

CPU = torch.device("cpu")
U = 2.0 ** -8  # bf16's unit roundoff: 8 significant bits
# The scale of the comparisons with JAX: a power of two, so q * SCALE is
# exact in bf16 and mha_reference_bwd (sm_scale 1.0 only) sees the same
# scores.
SCALE = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rounding_terms(q, k, v, o, lse, do, scale):
    """(B, H, T, d) f32, for dq, dk, dv: T, the sums of |products| each
    entry adds (|dS| |K|, |dS|^T |Q|, P^T |dO|), and F, the same sums over
    the magnitudes whose difference dS is, P (|dO| |V|^T + sum_d |O dO|)
    |scale|, where dP - Di cancels (F for dv is 0: no difference there)."""
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    p = torch.exp2(q @ k.transpose(-1, -2) * (scale * attention.LOG2E) - lse[..., None])
    ds = ((do @ v.transpose(-1, -2)) - (o * do).sum(-1, keepdim=True)) * p * scale
    e = p * (do.abs() @ v.abs().transpose(-1, -2) + (o * do).abs().sum(-1, keepdim=True)) * abs(scale)
    terms = (ds.abs() @ k.abs(), ds.abs().transpose(-1, -2) @ q.abs(),
             p.transpose(-1, -2) @ do.abs())
    return terms, (e @ k.abs(), e.transpose(-1, -2) @ q.abs(), 0)


def _assert_within(got, want, terms, sides: int, extra=(0, 0, 0)):
    """Each gradient within ``sides`` u T + 2u |want| + 2**-16 F (+
    ``extra``): the f32 sums of a d-long product in other orders and the
    exponentials differ by well under 2**-16 of their terms."""
    (t_terms, f_terms) = terms
    for name, g, w, t, f, e in zip(("dq", "dk", "dv"), got, want, t_terms, f_terms, extra):
        w = w.float()
        bound = sides * U * t + 2 * U * w.abs() + 2.0 ** -16 * f + e
        err = (g.float() - w).abs()
        assert bool((err <= bound).all()), (name, float((err / bound).max()))


def _jax_reference(q, k, v, do, dtype):
    """mha_reference_bwd's (dq, dk, dv) at SCALE, and (o, lse) of the f32
    forward on the operands' values, o rounded to ``dtype``."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        mha_reference_bwd,
        mha_reference_no_custom_vjp,
    )

    jdt = jnp.dtype(dtype)
    qs, ks, vs, dos = (jnp.asarray(x, jdt) for x in (q * SCALE, k, v, do))
    o, l, m = mha_reference_no_custom_vjp(*(x.astype(jnp.float32) for x in (qs, ks, vs)),
                                          save_residuals=True)
    o = o.astype(jdt)
    dq, dk, dv = mha_reference_bwd(qs, ks, vs, None, None, o, l, m, dos)[:3]
    lse = (np.asarray(m, np.float64) + np.log(np.asarray(l, np.float64))) * np.log2(np.e)
    grads = [np.array(x.astype(jnp.float32)) for x in (dq, dk, dv)]
    grads[0] = grads[0] * SCALE  # the gradient with respect to q, not q * SCALE
    return grads, np.array(o.astype(jnp.float32)), lse.astype(np.float32)


TWIN_CASES = {f"d{d}": (d, 128) for d in (16, 32, 64, 128)}
TWIN_CASES["d64_tk100"] = (64, 100)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_matches_stock_reference_bwd(case, dtype):
    """B and H of 2, Tq 128, Tk 128 or a ragged 100."""
    d, tk = TWIN_CASES[case]
    q, do = _normal((2, 2, 128, d), 0), _normal((2, 2, 128, d), 3)
    k, v = _normal((2, 2, tk, d), 1), _normal((2, 2, tk, d), 2)
    want, o, lse = _jax_reference(q, k, v, do, dtype)
    tdt = getattr(torch, dtype)
    x = [torch.from_numpy(a).to(tdt) for a in (q, k, v, o)]
    got = attention.flash_attention_backward_reference(
        *x, torch.from_numpy(lse), torch.from_numpy(do).to(tdt), SCALE)
    assert all(g.dtype == tdt and g.shape == a.shape for g, a in zip(got, x))
    want = [torch.from_numpy(w) for w in want]
    if dtype == "float32":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    else:
        terms = _rounding_terms(*x, torch.from_numpy(lse), torch.from_numpy(do).to(tdt), SCALE)
        _assert_within(got, want, terms, sides=1)


def test_twin_matches_headpacked_custom_vjp_bf16():
    """(2, 128, 4, 16) bf16 against jax.vjp of the JAX head-packed
    attention (its forward the Pallas kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from eyegaze_tpu.ops.attn_kernels import headpacked_attention as jax_headpacked

    shape = (2, 128, 4, 16)
    q, k, v, g = (_normal(shape, seed) for seed in range(4, 8))
    o, vjp = jax.vjp(lambda a, b, c: jax_headpacked(a, b, c, SCALE, True),
                     *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = [torch.from_numpy(np.asarray(w.astype(jnp.float32))).transpose(1, 2)
            for w in vjp(jnp.asarray(g, jnp.bfloat16))]
    qt, kt, vt, gt = (torch.from_numpy(x).to(torch.bfloat16).transpose(1, 2)
                      for x in (q, k, v, g))
    ot = torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(torch.bfloat16).transpose(1, 2)
    lse = attention.attention_lse_reference(qt, kt, SCALE)
    got = attention.flash_attention_backward_reference(qt, kt, vt, ot, lse, gt, SCALE)

    # Di from the bf16 output against the custom_vjp's sum_k dP P.
    q32, k32, v32, g32 = (x.float() for x in (qt, kt, vt, gt))
    p = torch.softmax(q32 @ k32.transpose(-1, -2) * SCALE, dim=-1)
    di_vjp = ((g32 @ v32.transpose(-1, -2)) * p).sum(-1)
    di_flash = (ot.float() * g32).sum(-1)
    assert float((di_flash - di_vjp).abs().max()) > 0  # the two backwards round Di apart
    a = (g32.abs() * (p @ v32.abs() + ot.float().abs())).sum(-1, keepdim=True)  # |ΔDi| <= u a
    assert bool(((di_flash - di_vjp).abs() <= U * a[..., 0] + 1e-6).all())
    extra = (U * SCALE * a * (p @ k32.abs()), U * SCALE * p.transpose(-1, -2) @ (a * q32.abs()), 0)
    _assert_within(got, want, _rounding_terms(qt, kt, vt, ot, lse, gt, SCALE), sides=1,
                   extra=extra)


@pytest.mark.parametrize("entry", ["flash_attention", "headpacked_attention"])
def test_bf16_functions_on_cpu_run_the_twins(entry):
    """bf16, ragged Tk (40 keys for 64 queries), B 2, H 3, d 16."""
    t_dim = 2 if entry == "flash_attention" else 1
    q, k, v, g = (torch.from_numpy(_normal(s, seed)).to(torch.bfloat16)
                  for seed, s in enumerate([(2, 64, 3, 16), (2, 40, 3, 16), (2, 40, 3, 16),
                                            (2, 64, 3, 16)]))
    if t_dim == 2:
        q, k, v, g = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    fn = getattr(attention, entry)
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    before = (dict(attention.backward_count), dict(attention.stock_backward_count),
              dict(attention.backward_launch_count), dict(attention.launch_count))
    out = fn(*x, 0.25)
    assert type(out.grad_fn).__name__ == ("_FlashAttentionBackward" if t_dim == 2
                                          else "_HeadpackedAttentionBackward")
    got = torch.autograd.grad(out, x, g)

    def bhtd(a):
        return a if t_dim == 2 else a.transpose(1, 2)

    qt, kt, vt, gt = (bhtd(a) for a in (q, k, v, g))
    o = attention.attention_reference(qt, kt, vt, 0.25)
    assert torch.equal(bhtd(out.detach()), o)
    want = attention.flash_attention_backward_reference(
        qt, kt, vt, o, attention.attention_lse_reference(qt, kt, 0.25), gt, 0.25)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(bhtd(a), w)
    assert attention.backward_count == {**before[0], entry: before[0][entry] + 1}
    assert attention.stock_backward_count == before[1]  # no stock backward in bf16
    assert attention.backward_launch_count == before[2]  # no kernel on the CPU
    assert attention.launch_count == before[3]


@pytest.mark.parametrize("entry", ["flash_attention", "headpacked_attention"])
def test_f32_functions_keep_the_stock_backward(entry):
    t_dim = 2 if entry == "flash_attention" else 1
    q, k, v, g = (torch.from_numpy(_normal((2, 32, 2, 16), seed)) for seed in range(4))
    if t_dim == 2:
        q, k, v, g = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    before = dict(attention.stock_backward_count)
    got = torch.autograd.grad(getattr(attention, entry)(*x, 0.25), x, g)
    assert attention.stock_backward_count == {**before, "float32": before["float32"] + 1}

    def bthd(a):
        return a.transpose(1, 2) if t_dim == 2 else a

    want = attention.attention_backward_reference(*(bthd(a) for a in (q, k, v, g)), 0.25)
    for a, w in zip(got, want):
        assert torch.equal(bthd(a), w)


def test_lse_reference_is_the_row_logsumexp_base_2():
    q, k = (torch.from_numpy(_normal((2, 2, 16, 16), seed)) for seed in range(2))
    scores = (q @ k.transpose(-1, -2) * 0.25).double()
    want = torch.log2(torch.exp(scores).sum(-1))
    torch.testing.assert_close(attention.attention_lse_reference(q, k, 0.25).double(), want,
                               rtol=0, atol=1e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# The one-pass kernels cover Tk up to a cluster of 8 blocks of 128 keys, at
# the head dims where they are faster than the two kernels (16 on mma.sync,
# 64 on wgmma); every other call takes the dQ and dK/dV kernels.
ONE_PASS_MAX_KEYS = 1024
ONE_PASS_PATHS = {16: "one_pass", 64: "one_pass_wgmma"}


def _path(tk: int, d: int) -> str:
    return ONE_PASS_PATHS.get(d, "two_kernel") if tk <= ONE_PASS_MAX_KEYS else "two_kernel"


# (entry, (B, Tq, H, d), Tk, scale, how the output gradient arrives).
KERNEL_CASES = {
    "art": ("headpacked_attention", (16, 1024, 8, 16), 1024, 0.25, "contiguous"),
    "d32": ("headpacked_attention", (2, 256, 4, 32), 256, 32 ** -0.5, "contiguous"),
    "d64_cross_ragged": ("headpacked_attention", (2, 1024, 4, 64), 1000, 0.125, "contiguous"),
    "d16_tq200_tk1": ("headpacked_attention", (3, 200, 8, 16), 1, 0.25, "contiguous"),
    "d16_tq1_tk65_negative_scale": ("headpacked_attention", (3, 1, 8, 16), 65, -0.25,
                                    "contiguous"),
    "d32_tq257_tk1000": ("headpacked_attention", (2, 257, 4, 32), 1000, 0.2, "expanded"),
    "k4": ("flash_attention", (2, 1024, 8, 128), 1024, 128 ** -0.5, "contiguous"),
    "k4_views": ("flash_attention", (2, 1024, 8, 128), 1024, 128 ** -0.5, "views"),
    "d128_tq1000_tk200": ("flash_attention", (2, 1000, 2, 128), 200, 0.1, "contiguous"),
    "d128_tq33_tk1000_negative_scale": ("flash_attention", (1, 33, 2, 128), 1000, -0.1,
                                        "views"),
    "d64_expanded": ("flash_attention", (2, 256, 4, 64), 256, 0.125, "expanded"),
    "d16_tk_at_limit": ("headpacked_attention", (2, 300, 4, 16), ONE_PASS_MAX_KEYS, 0.25,
                        "contiguous"),
    "d16_tk_past_limit": ("headpacked_attention", (2, 300, 4, 16), ONE_PASS_MAX_KEYS + 1,
                          0.25, "contiguous"),
    "d128_tk_past_limit": ("flash_attention", (1, 200, 2, 128), ONE_PASS_MAX_KEYS + 1,
                           128 ** -0.5, "contiguous"),
    "d16_tk1000_ragged": ("headpacked_attention", (4, 1024, 8, 16), 1000, 0.25, "contiguous"),
    "d128_tk1000_ragged": ("flash_attention", (2, 1024, 4, 128), 1000, 128 ** -0.5,
                           "contiguous"),
    "d64_negative_scale": ("headpacked_attention", (2, 512, 4, 64), 768, -0.125, "contiguous"),
    "d64_tk_at_limit": ("flash_attention", (2, 300, 4, 64), ONE_PASS_MAX_KEYS, 0.125, "views"),
    "d64_tk_past_limit": ("headpacked_attention", (2, 300, 4, 64), ONE_PASS_MAX_KEYS + 1,
                          0.125, "contiguous"),
    "d64_tq100_tk70": ("headpacked_attention", (3, 100, 2, 64), 70, 0.125, "expanded"),
    "d64_tq1_tk129": ("flash_attention", (1, 1, 2, 64), 129, -0.125, "contiguous"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_backward_kernels_match_twin_on_card(case):
    """The Function's forward log-sum-exp within 1e-4 (base 2) of the twin's
    and its dq, dk, dv within 2u T + 2u |want| of the twin backward on the
    same forward output; one forward launch, one backward call, and the
    launches of the path it takes (one for a one-pass kernel, two for the
    dQ and dK/dV kernels), none of another.  The flash cases pass (B, T, H, d) tensors seen
    through ``transpose(1, 2)`` where the case says views; an expanded output
    gradient is the gradient of ``out.sum()`` times a vector, stride 0."""
    dev = _card()
    entry, (b, tq, h, d), tk, scale, grad = KERNEL_CASES[case]
    r = np.random.default_rng(13)
    x = [torch.from_numpy(r.normal(size=(b, t, h, d)).astype(np.float32)).to(dev, torch.bfloat16)
         for t in (tq, tk, tk)]
    flash = entry == "flash_attention"
    if flash:
        x = [a.transpose(1, 2) if grad == "views" else a.transpose(1, 2).contiguous() for a in x]
    x = [a.requires_grad_() for a in x]
    before = (dict(attention.launch_count), dict(attention.backward_count),
              dict(attention.backward_launch_count), dict(attention.stock_backward_count))
    out = getattr(attention, entry)(*x, scale)
    lse = out.grad_fn.saved_tensors[4]
    if grad == "expanded":
        g = torch.from_numpy(r.normal(size=out.shape[-1]).astype(np.float32)).to(
            dev, torch.bfloat16).expand(out.shape)
        assert 0 in g.stride()
    else:
        g = torch.from_numpy(r.normal(size=tuple(out.shape)).astype(np.float32)).to(
            dev, torch.bfloat16)
    got = torch.autograd.grad(out, x, g)
    torch.cuda.synchronize()
    assert attention.launch_count[entry] == before[0][entry] + 1
    assert attention.backward_count[entry] == before[1][entry] + 1
    path = _path(tk, d)
    assert attention.backward_path(tk, d) == path
    launches = {"one_pass": 1, "two_kernel": 2, "one_pass_wgmma": 1}
    assert attention.backward_launch_count == {
        p: before[2][p] + (launches[p] if p == path else 0) for p in launches}
    assert attention.stock_backward_count == before[3]

    def bhtd(a):
        return a if flash else a.transpose(1, 2)

    q, k, v = (bhtd(a.detach()) for a in x)
    o, gt = bhtd(out.detach()), bhtd(g)
    torch.testing.assert_close(lse, attention.attention_lse_reference(q, k, scale), rtol=0,
                               atol=1e-4)
    want = attention.flash_attention_backward_reference(q, k, v, o, lse, gt, scale)
    _assert_within([bhtd(a) for a in got], want, _rounding_terms(q, k, v, o, lse, gt, scale),
                   sides=2)
    for a, w in zip(got, x):
        assert a.shape == w.shape and a.dtype == torch.bfloat16


# (entry, shape in the entry's layout): a small head-packed shape and ART's
# training shape (the one-pass kernel), K4's flash shape (d = 128: the dQ
# and dK/dV kernels) and d = 64 at the same work (the wgmma one-pass kernel).
DETERMINISM_CASES = {
    "small": ("headpacked_attention", (4, 512, 8, 16)),
    "art": ("headpacked_attention", (16, 1024, 8, 16)),
    "k4": ("flash_attention", (2, 8, 1024, 128)),
    "d64": ("headpacked_attention", (4, 1024, 8, 64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DETERMINISM_CASES))
def test_backward_kernels_are_deterministic_on_card(case):
    """No atomics: two backward passes give the same bits (the one-pass
    kernels sum the cluster's partial dQ tiles in rank order)."""
    dev = _card()
    entry, shape = DETERMINISM_CASES[case]
    fn = getattr(attention, entry)
    x = [torch.randn(*shape, device=dev, dtype=torch.bfloat16).requires_grad_()
         for _ in range(3)]
    g = torch.randn(*shape, device=dev, dtype=torch.bfloat16)
    path = _path(shape[2 if entry == "flash_attention" else 1], shape[-1])
    before = dict(attention.backward_launch_count)
    first = torch.autograd.grad(fn(*x, shape[-1] ** -0.5), x, g)
    second = torch.autograd.grad(fn(*x, shape[-1] ** -0.5), x, g)
    assert attention.backward_launch_count[path] == before[path] + 2 * attention.BACKWARD_LAUNCHES[path]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_backward_source_sums_no_gradient_with_atomics():
    """Every gradient is written once, by one thread: the source holds no
    atomic add or reduction (``atomicAdd``, ``atom.``, ``red.``)."""
    import re

    from eyegaze_tpu_torch.kernels import build

    text = (build.CSRC / "attention.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomicAdd" not in code
    assert not re.search(r"(?<![A-Za-z_])(atom|red)\.", code)  # PTX atom.* and red.*
