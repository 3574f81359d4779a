"""Phase-metrics kernels (K1 and the widened K2) of the PyTorch port against
the JAX package.

The plain versions ``pairwise_phase_metrics_reference`` and
``pairwise_phase_plv_metrics_reference`` are held to the JAX broadcast-reduce
(``_pairwise_phase_metrics_xla``), to ``_plv_matrix`` and to the Pallas
kernels in interpret mode, on the same numpy inputs, at the tolerances of
tests/test_pallas.py.  The CUDA kernels themselves run only on the card
(``cuda`` marker); jax is imported inside the tests that compare against
it, so the card's tests run where jax is not installed:

    python -m pytest tests/test_torch_phase_metrics.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch.kernels import phase_metrics


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(n, c, t, seed=0):
    r = np.random.default_rng(seed)
    ph1 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2 = r.uniform(-np.pi, np.pi, (n, c, t)).astype(np.float32)
    ph2[:, 0] = ph1[:, 0]  # exact ties: sign(0) = 0 on one row of pairs
    pw1 = r.random((n, c, t)).astype(np.float32)
    pw2 = r.random((n, c, t)).astype(np.float32)
    return ph1, ph2, pw1, pw2


def _assemble(sums, pw1, pw2, eps=1e-8):
    mean_sgn, wnum, pdiff = (s.numpy() for s in sums)
    den = (pw1.sum(-1)[:, :, None] + pw2.sum(-1)[:, None, :]) * 0.5
    return np.abs(mean_sgn), np.abs(wnum / (den + eps)), pdiff


def _assert_metrics_close(got, want):
    for name, g, w, rtol in zip(("PLI", "wPLI", "Phase_Diff"), got, want, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [(3, 8, 256), (2, 6, 100)], ids=["aligned", "ragged"])
def test_reference_matches_jax_xla(shape):
    import jax.numpy as jnp

    from eyegaze_tpu.ops.connectivity import _pairwise_phase_metrics_xla

    ph1, ph2, pw1, pw2 = _inputs(*shape)
    sums = phase_metrics.pairwise_phase_metrics_reference(
        *(torch.from_numpy(a) for a in (ph1, ph2, pw1, pw2)), row_chunk=4)
    want = _pairwise_phase_metrics_xla(*(jnp.asarray(a) for a in (ph1, ph2, pw1, pw2)),
                                       eps=1e-8, row_chunk=shape[1] // 2)
    _assert_metrics_close(_assemble(sums, pw1, pw2), want)


def test_reference_matches_pallas_interpret():
    import jax.numpy as jnp

    from eyegaze_tpu.ops.pallas_kernels import pairwise_phase_metrics as pallas_phase_metrics

    ph1, ph2, pw1, pw2 = _inputs(3, 8, 256, seed=1)
    sums = phase_metrics.pairwise_phase_metrics_reference(
        *(torch.from_numpy(a) for a in (ph1, ph2, pw1, pw2)))
    want = pallas_phase_metrics(*(jnp.asarray(a) for a in (ph1, ph2, pw1, pw2)),
                                interpret=True)
    _assert_metrics_close(_assemble(sums, pw1, pw2), want)


def test_cpu_wrapper_takes_plain_path_without_launching():
    ph1, ph2, pw1, pw2 = (torch.from_numpy(a) for a in _inputs(2, 8, 128, seed=2))
    before = dict(phase_metrics.launch_count)
    pli, wpli, pdiff = phase_metrics.pairwise_phase_metrics(ph1, ph2, pw1, pw2)
    assert phase_metrics.launch_count == before
    want = _assemble(phase_metrics.pairwise_phase_metrics_reference(ph1, ph2, pw1, pw2),
                     pw1.numpy(), pw2.numpy())
    for g, w in zip((pli, wpli, pdiff), want):  # numpy sums the denominator in another order
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    # Identical phases on pair (0, 0): sign(0) = 0 and |0| = 0 at every sample.
    assert torch.all(pli[:, 0, 0] == 0) and torch.all(pdiff[:, 0, 0] == 0)


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 4, 16))
    before = dict(phase_metrics.launch_count)
    with pytest.raises(TypeError, match="float32"):
        phase_metrics.phase_metric_sums(x.double(), x, x, x)
    with pytest.raises(ValueError, match="shape"):
        phase_metrics.phase_metric_sums(x, x[:, :3], x, x)
    with pytest.raises(ValueError, match="contiguous"):
        phase_metrics.phase_metric_sums(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2),
                                        x.transpose(1, 2))
    with pytest.raises(ValueError, match="N, C, T"):
        phase_metrics.phase_metric_sums(x[0], x[0], x[0], x[0])
    assert phase_metrics.launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 32, 1024), (7, 30, 1000)], ids=["slice", "ragged"])
def test_kernel_matches_reference_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays = _inputs(*shape, seed=3)
    x = [torch.from_numpy(a).cuda() for a in arrays]
    before = phase_metrics.launch_count["phase_metric_sums"]
    got = phase_metrics.phase_metric_sums(*x)
    torch.cuda.synchronize()
    assert phase_metrics.launch_count["phase_metric_sums"] == before + 1
    want = phase_metrics.pairwise_phase_metrics_reference(*x)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    den = (x[2].sum(-1)[:, :, None] + x[3].sum(-1)[:, None, :]) * 0.5
    # wnum is a signed sum: its rounding error scales with sum |terms| = den.
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6 * float(den.max()))
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


def _assert_plv_metrics_close(got, want):
    """(plv, pli, wpli, pdiff) at tests/test_pallas.py's tolerances."""
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=1e-4, atol=1e-5,
                               err_msg="PLV")
    _assert_metrics_close(got[1:], want[1:])


@pytest.mark.parametrize("shape", [(3, 8, 256), (2, 6, 100)], ids=["aligned", "ragged"])
def test_plv_reference_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from eyegaze_tpu.ops.pallas_kernels import pairwise_phase_plv_metrics as pallas_plv_metrics

    arrays = _inputs(*shape, seed=4)
    got = phase_metrics.pairwise_phase_plv_metrics(*(torch.from_numpy(a) for a in arrays))
    want = pallas_plv_metrics(*(jnp.asarray(a) for a in arrays), interpret=True)
    _assert_plv_metrics_close([g.numpy() for g in got], want)


def test_plv_matches_jax_plv_matrix():
    """The widened route's PLV against the production four-matmul PLV on
    cos / sin of the same phases."""
    import jax.numpy as jnp

    from eyegaze_tpu.ops.connectivity import _plv_matrix

    ph1, ph2, pw1, pw2 = _inputs(3, 8, 256, seed=5)
    plv = phase_metrics.pairwise_phase_plv_metrics(
        *(torch.from_numpy(a) for a in (ph1, ph2, pw1, pw2)))[0]
    c1, s1, c2, s2 = (jnp.asarray(f(p)) for p in (ph1, ph2) for f in (np.cos, np.sin))
    want = _plv_matrix(c1, s1, c2, s2)
    np.testing.assert_allclose(plv.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plv_cpu_wrapper_takes_plain_path_without_launching():
    ph1, ph2, pw1, pw2 = (torch.from_numpy(a) for a in _inputs(2, 8, 100, seed=6))
    before = dict(phase_metrics.launch_count)
    plv, pli, wpli, pdiff = phase_metrics.pairwise_phase_plv_metrics(ph1, ph2, pw1, pw2)
    assert phase_metrics.launch_count == before
    sums = phase_metrics.pairwise_phase_plv_metrics_reference(ph1, ph2, pw1, pw2)
    want = _assemble(sums[:3], pw1.numpy(), pw2.numpy())
    for g, w in zip((pli, wpli, pdiff), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(plv.numpy(), np.hypot(sums[3].numpy(), sums[4].numpy()),
                               rtol=1e-6, atol=1e-7)
    # K2's sums begin with K1's: the same broadcast-reduce.
    for g, w in zip(sums[:3], phase_metrics.pairwise_phase_metrics_reference(ph1, ph2, pw1, pw2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Identical phases on pair (0, 0): sign 0, |dphi| 0, cos 1, sin 0.
    assert torch.all(pli[:, 0, 0] == 0) and torch.all(pdiff[:, 0, 0] == 0)
    torch.testing.assert_close(plv[:, 0, 0], torch.ones(2), rtol=0, atol=1e-6)


def test_plv_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 4, 16))
    before = dict(phase_metrics.launch_count)
    with pytest.raises(TypeError, match="float32"):
        phase_metrics.phase_plv_metric_sums(x, x, x.half(), x)
    with pytest.raises(ValueError, match="shape"):
        phase_metrics.phase_plv_metric_sums(x, x, x, x[:1])
    with pytest.raises(ValueError, match="contiguous"):
        phase_metrics.phase_plv_metric_sums(*(x.transpose(1, 2) for _ in range(4)))
    with pytest.raises(ValueError, match="N, C, T"):
        phase_metrics.phase_plv_metric_sums(x[None], x[None], x[None], x[None])
    meta = x.to("meta")  # a device with no kernel and no plain path
    with pytest.raises(RuntimeError, match="no phase-metrics kernel"):
        phase_metrics.phase_plv_metric_sums(meta, meta, meta, meta)
    assert phase_metrics.launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 32, 1024), (7, 30, 1000)], ids=["shootout", "ragged"])
def test_plv_kernel_matches_reference_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    arrays = _inputs(*shape, seed=7)
    x = [torch.from_numpy(a).cuda() for a in arrays]
    before = phase_metrics.launch_count["phase_plv_metric_sums"]
    got = phase_metrics.phase_plv_metric_sums(*x)
    torch.cuda.synchronize()
    assert phase_metrics.launch_count["phase_plv_metric_sums"] == before + 1
    want = phase_metrics.pairwise_phase_plv_metrics_reference(*x)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    den = (x[2].sum(-1)[:, :, None] + x[3].sum(-1)[:, None, :]) * 0.5
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6 * float(den.max()))
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    # cos(a - b) from sincosf of each sample against cos of the difference:
    # a few ulps per term (tests/test_pallas.py's bound).
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=1e-5)
    # The tied pair (0, 0): samples past a ragged T add nothing, so mean cos is 1.
    assert not got[0][:, 0, 0].any() and not got[2][:, 0, 0].any()
    torch.testing.assert_close(got[3][:, 0, 0], torch.ones_like(got[3][:, 0, 0]), rtol=0,
                               atol=1e-5)
