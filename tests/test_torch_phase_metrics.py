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


# The EEG serving run's N = 6 x bucket at C = 32, T = 1024, a ragged shape and
# one whose T is not a multiple of 4 (rows staged element by element).
CARD_SHAPES = [(48, 32, 1024), (7, 30, 1000), (6, 32, 1024), (192, 32, 1024), (768, 32, 1024),
               (7, 30, 1001)]
CARD_IDS = ["slice", "ragged", "n6", "n192", "n768", "t1001"]
PLV_CARD_SHAPES = [(64, 32, 1024), (7, 30, 1000), (768, 32, 1024), (48, 32, 1024),
                   (7, 30, 1001)]
PLV_CARD_IDS = ["shootout", "ragged", "n768", "split", "t1001"]
WRAPPERS = ["phase_metric_sums", "phase_plv_metric_sums"]
REFERENCES = {"phase_metric_sums": phase_metrics.pairwise_phase_metrics_reference,
              "phase_plv_metric_sums": phase_metrics.pairwise_phase_plv_metrics_reference}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _check_on_card(wrapper, x):
    """One launch against the plain version, the tied pair (0, 0), and a
    second launch that must give the same bits."""
    kernel = getattr(phase_metrics, wrapper)
    before = phase_metrics.launch_count[wrapper]
    got = kernel(*x)
    torch.cuda.synchronize()
    assert phase_metrics.launch_count[wrapper] == before + 1
    phase_metrics.assert_sums_close(got, REFERENCES[wrapper](*x), x[2], x[3])
    # Identical phases on pair (0, 0): sign 0 and |dphi| 0 at every sample, and
    # samples past a ragged T add nothing, so the mean cos is 1.
    assert not got[0][:, 0, 0].any() and not got[2][:, 0, 0].any()
    if len(got) == 5:
        torch.testing.assert_close(got[3][:, 0, 0], torch.ones_like(got[3][:, 0, 0]), rtol=0,
                                   atol=1e-5)
    again = kernel(*x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=CARD_IDS)
def test_kernel_matches_reference_on_card(shape):
    _needs_card()
    _check_on_card("phase_metric_sums",
                   [torch.from_numpy(a).cuda() for a in _inputs(*shape, seed=3)])


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_kernel_stages_unaligned_rows_on_card(wrapper):
    """Contiguous views 4 bytes past a 16-byte boundary: the kernel stages
    their rows element by element."""
    _needs_card()
    x = []
    for a in _inputs(5, 32, 256, seed=8):
        base = torch.empty(a.size + 1, device="cuda")
        view = base[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        x.append(view)
    _check_on_card(wrapper, x)


@pytest.mark.cuda
def test_split_on_card():
    """T is split over a cluster where the grid would leave SMs idle, and
    not at the 16-trial request's N = 768."""
    _needs_card()
    assert phase_metrics.split(48, 32, 1024) > 1
    assert phase_metrics.split(768, 32, 1024) == 1
    assert 1 <= phase_metrics.split(1, 32, 64) <= 2  # each block keeps a chunk of 32


@pytest.mark.parametrize("n, c, split, blocks", [(48, 32, 8, 384), (768, 32, 1, 768),
                                                 (7, 30, 2, 14), (2, 33, 1, 8)])
def test_grid_blocks(n, c, split, blocks):
    assert phase_metrics.grid_blocks(n, c, split) == blocks


@pytest.mark.parametrize("shape", [(0, 32, 1024), (1, 0, 8), (1, 32, 2**31)])
def test_split_rejects_a_shape_without_a_launch(shape):
    """Checked before the library is loaded, so it raises here, without nvcc."""
    with pytest.raises(ValueError, match="no launch"):
        phase_metrics.split(*shape)
    if min(shape[:2]) < 1:
        with pytest.raises(ValueError, match="no launch"):
            phase_metrics.grid_blocks(shape[0], shape[1], 1)


@pytest.mark.parametrize("index", range(5), ids=["mean_sign", "wnum", "pdiff", "cos", "sin"])
def test_assert_sums_close_holds_each_sum(index):
    """The kernels' tolerance check passes the plain sums and fails each sum
    moved past its tolerance."""
    x = [torch.from_numpy(a) for a in _inputs(2, 8, 128, seed=9)]
    want = phase_metrics.pairwise_phase_plv_metrics_reference(*x)
    errs = phase_metrics.assert_sums_close(want, want, x[2], x[3])
    assert errs == [0.0] * 5
    got = list(want)
    got[index] = got[index].clone()
    got[index][1, 2, 3] += 1e-2 if index != 1 else 1.0
    with pytest.raises(AssertionError):
        phase_metrics.assert_sums_close(got, want, x[2], x[3])


def test_cpu_wrapper_takes_a_view_at_an_offset():
    arrays = _inputs(2, 8, 101, seed=10)
    x = []
    for a in arrays:
        base = torch.zeros(a.size + 1)
        base[1:] = torch.from_numpy(a.ravel())
        x.append(base[1:].view(a.shape))
    for wrapper in WRAPPERS:
        got = getattr(phase_metrics, wrapper)(*x)
        want = REFERENCES[wrapper](*(torch.from_numpy(a) for a in arrays))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_entries_match_the_wrappers():
    assert set(phase_metrics.ENTRIES) == set(phase_metrics.launch_count) == set(WRAPPERS)
    assert [phase_metrics.ENTRIES[w][1] for w in WRAPPERS] == [3, 5]


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
@pytest.mark.parametrize("shape", PLV_CARD_SHAPES, ids=PLV_CARD_IDS)
def test_plv_kernel_matches_reference_on_card(shape):
    _needs_card()
    _check_on_card("phase_plv_metric_sums",
                   [torch.from_numpy(a).cuda() for a in _inputs(*shape, seed=7)])
