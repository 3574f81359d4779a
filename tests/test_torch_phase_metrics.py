"""Phase-metrics kernel (K1) of the PyTorch port against the JAX package.

The plain version ``pairwise_phase_metrics_reference`` is held to the JAX
broadcast-reduce (``_pairwise_phase_metrics_xla``) and to the Pallas kernel
in interpret mode, on the same numpy inputs, at the tolerances of
tests/test_pallas.py.  The CUDA kernel itself runs only on the card
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
    before = phase_metrics.launch_count
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
    before = phase_metrics.launch_count
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
    before = phase_metrics.launch_count
    got = phase_metrics.phase_metric_sums(*x)
    torch.cuda.synchronize()
    assert phase_metrics.launch_count == before + 1
    want = phase_metrics.pairwise_phase_metrics_reference(*x)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    den = (x[2].sum(-1)[:, :, None] + x[3].sum(-1)[:, None, :]) * 0.5
    # wnum is a signed sum: its rounding error scales with sum |terms| = den.
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6 * float(den.max()))
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
