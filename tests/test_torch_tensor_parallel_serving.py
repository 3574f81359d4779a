"""Serving on a mesh in the port (``serving``'s ``mesh=``, ``serve --mesh``)
against unsharded serving, on the CPU.

- Two gloo ranks, started once for the module by ``parallel.launch``
  (``tests/_torch_tp_ranks.py``): the five predictors (the flagship, the
  early-fusion ViT, ART, the composite, HyperEEG) at tiny widths with 4
  heads, served at ``dp1,tp2`` (2 heads a rank, the Megatron layers of
  ``parallel/tensor.py``) and at ``dp2`` (each rank its rows of a bucket),
  in float32 (within 1e-5 of the largest output of the unsharded
  predictor) and in bf16 from the checkpoint (within JAX's own 2e-2 of
  tests/test_serving.py:90); the buckets round up to multiples of dp;
- ``ArtDenoiser`` with ``recon_zscore="batch"`` refuses ``dp2`` with the
  JAX message and serves ``dp1,tp2``, sample by sample, as one process;
- a predictor with a mesh and no running group raises, naming
  ``parallel.launch``;
- ``python -m eyegaze_tpu_torch.serve --device cpu --mesh dp1,tp2`` driven
  through its ``main`` (rank 0 in this process, rank 1 spawned) answers
  HTTP requests, through the dynamic batcher, equal to the unsharded
  server's, and its followers stop with the server.
"""

import io
import threading
import urllib.request

import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from eyegaze_tpu_torch import parallel, serve, serving

CPU = torch.device("cpu")
F32_SHARE = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    paths = ranks.write_checkpoints(str(tmp_path_factory.mktemp("ckpt")))
    got = parallel.launch(ranks.serving_checks, 2, {"paths": paths},
                          store_dir=tmp_path_factory.mktemp("store"))
    return {"paths": paths, "ranks": got, "one": ranks.serve_all(paths, None, CPU)}


@pytest.mark.parametrize("mesh", ["tp", "dp"])
@pytest.mark.parametrize("kind", ranks.KINDS)
def test_predictors_on_a_mesh_match_one_process(world2, kind, mesh):
    want = world2["one"][kind]
    for out in world2["ranks"]:  # every rank gathers the whole answer
        got = out[mesh][kind]
        assert got["f32"].shape == want["f32"].shape
        np.testing.assert_allclose(got["f32"], want["f32"], rtol=0,
                                   atol=F32_SHARE * np.abs(want["f32"]).max())
        np.testing.assert_allclose(got["bf16"], want["bf16"], rtol=BF16_TOL, atol=BF16_TOL)
        # Buckets (2, 4) round up to multiples of dp: at dp2 both are.
        assert got["buckets"] == (2, 4)


def test_batch_zscore_art_refuses_dp_and_serves_tp(world2):
    for out in world2["ranks"]:
        assert "recon_zscore='batch' checkpoints serve per-sample" in out["art_batch_dp2"]
        assert out["art_batch_tp"]["buckets"] == (1,)
        want = ranks.art_batch_one_process()
        got = out["art_batch_tp"]["denoised"]
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_SHARE * np.abs(want).max())


def test_a_mesh_needs_a_running_group(world2):
    with pytest.raises(ValueError, match="parallel.launch"):
        serving.Predictor.from_checkpoint(world2["paths"]["eeg"], device=CPU, mesh="tp2")


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(f"{url}/predict?format=npz", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return dict(np.load(io.BytesIO(r.read())))


def _serve(argv):
    """``serve.main(argv)`` in a thread; (url, stop)."""
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=serve.main, args=(argv, on_ready), daemon=True)
    thread.start()
    assert ready.wait(180), "the server did not come up"
    server = box["server"]

    def stop():
        server.shutdown()
        thread.join(120)
        assert not thread.is_alive()

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def test_serve_mesh_answers_as_the_unsharded_server(world2):
    path = world2["paths"]["eeg"]
    common = ["--checkpoint", path, "--device", "cpu", "--port", "0", "--buckets", "4",
              "--no-warmup"]
    e1, e2 = ranks.serve_inputs("eeg", n=3, seed=7)
    url, stop = _serve(common)
    try:
        want = _post(url, {"eeg1": e1, "eeg2": e2})
    finally:
        stop()
    url, stop = _serve(common + ["--mesh", "dp1,tp2", "--dynamic-batch", "2"])
    try:
        with urllib.request.urlopen(f"{url}/info", timeout=60) as r:
            assert b'"batch_buckets": [4]' in r.read()
        got = [_post(url, {"eeg1": e1, "eeg2": e2}) for _ in range(2)]
    finally:
        stop()  # the stop header ends rank 1's loop: main returns
    for g in got:
        np.testing.assert_allclose(g["logits"], want["logits"], rtol=BF16_TOL, atol=BF16_TOL)
        np.testing.assert_array_equal(g["logits"], got[0]["logits"])
