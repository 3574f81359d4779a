"""The port's tensor-parallel rules and layers (``parallel/sharding.py``,
``parallel/tensor.py``) against the JAX package's ``parallel/sharding.py``
and against one process, on the CPU.

- ``mesh_world``: the ranks a spec asks for on the CPU (dp x tp, an unsized
  dp counting 1) and on CUDA (a spec that needs more cards than there are
  raises, as JAX's parse does).
- The rules: for every family (the flagship with cross-brain attention, ART,
  the early- and late-fusion ViTs, the composite, HyperEEG) at tp 2, 4 and
  8, the port's ``shard_report`` on the model against JAX's
  ``partition_spec_for`` on every leaf of the JAX model's parameters, each
  leaf marked by how it shards (0 replicated, 1 by output features, 2 by
  input features) and carried through the port's weight converter.  They
  agree everywhere except where an attention module's heads do not divide
  tp while its width does (the port's divisibility rule: whole heads on a
  rank), and the test lists those cases.
- Two gloo ranks, started once for the module by ``parallel.launch``
  (``tests/_torch_tp_ranks.py``):
  - a column and a row layer cut from a pair of ``Dense`` (x -> copy ->
    column -> ReLU -> row -> reduce + bias) against the pair in one
    process: the output and the gradients of x, both weights and both
    biases within 1e-6 of each tensor's largest entry, with one all_reduce
    forward and one backward;
  - the ViT attention's fused ``qkv`` split: rank r holds the rows of its
    heads in each of the q, k and v thirds, not a contiguous third, and
    ``proj`` the matching columns; the sharded attention's output equals
    one process's.
"""

import importlib.util
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_tp_ranks as ranks
from eyegaze_tpu.config import config_from_dict as jax_config_from_dict
from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.hypereeg import HyperEEGEncoder as JaxHyperEEG
from eyegaze_tpu.models.multimodal import MultimodalFusionModel as JaxMultimodal
from eyegaze_tpu.models.vit import EarlyFusionViT as JaxEarlyFusionViT
from eyegaze_tpu.models.vit import LateFusionViT as JaxLateFusionViT
from eyegaze_tpu.parallel import sharding as jax_sharding
from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.models import convert
from eyegaze_tpu_torch.models.vit import Attention, LateFusionViT

CPU = torch.device("cpu")
SHARE = 1e-6
LATE = dict(num_classes=3, img_size=ranks.IMG, fusion_mode="full", embed_dim=32, depth=2,
            num_heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("spec,ranks_", [("tp2", 2), ("dp2,tp2", 4), ("dp,tp2", 2), ("dp", 1),
                                         ("dp3", 3), ("tp4", 4), ("dp1,tp2", 2)])
def test_mesh_world_on_the_cpu(spec, ranks_):
    assert parallel.mesh_world(spec, "cpu") == ranks_


def test_mesh_world_on_cuda_raises_where_the_cards_run_out():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {2 * (n + 1)} devices, have {n}"):
        parallel.mesh_world(f"dp{n + 1},tp2", "cuda")


def _jax_flagship():
    spec = importlib.util.spec_from_file_location(
        "jax_train_dual_eeg", Path(__file__).resolve().parent.parent / "scripts" /
        "train_dual_eeg.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script.build_model(jax_config_from_dict(ranks.FLAGSHIP))


def _families():
    """name -> (JAX model, its init inputs, converter, port model)."""
    eeg = jnp.zeros((1, ranks.C, ranks.T), jnp.float32)
    img = jnp.zeros((1, 3, ranks.IMG, ranks.IMG), jnp.float32)
    art = jnp.zeros((1, ranks.ART_C, ranks.ART_T), jnp.float32)
    mm_eeg = jnp.zeros((1, ranks.C, 128), jnp.float32)
    g = torch.Generator().manual_seed(0)
    return {
        "flagship": (_jax_flagship(), (eeg, eeg), convert.dual_eeg_state_dict_from_flax,
                     ranks.build("flagship", None, CPU)),
        "art": (JaxArt(JaxArtConfig(**ranks.ART)), (art, art), convert.art_state_dict_from_flax,
                ranks.build("art", None, CPU)),
        "vit_early": (JaxEarlyFusionViT(**ranks.VIT), (img, img),
                      convert.gaze_early_state_dict_from_flax, ranks.build("vit", None, CPU)),
        "vit_late": (JaxLateFusionViT(**LATE), (img, img), convert.gaze_late_state_dict_from_flax,
                     LateFusionViT(**LATE, device=CPU, generator=g)),
        "multimodal": (JaxMultimodal(**ranks.MULTIMODAL), (img, img, mm_eeg, mm_eeg),
                       convert.multimodal_state_dict_from_flax, ranks.served_model("multimodal")),
        "hypereeg": (JaxHyperEEG(**ranks.HYPEREEG), (eeg, eeg),
                     convert.hypereeg_state_dict_from_flax, ranks.served_model("hypereeg")),
    }


def _jax_codes(model, inputs, tp: int) -> dict:
    """Every leaf of the JAX model's parameters filled with how
    ``partition_spec_for`` shards it at ``tp``: 0 replicated, 1 by output
    features (a kernel's last sharded axis, or a bias), 2 by input features
    (a kernel sharded on its first axis)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)["params"]
    mesh = types.SimpleNamespace(shape={jax_sharding.DATA_AXIS: 1, jax_sharding.MODEL_AXIS: tp})

    def code(path, leaf):
        path_s = jax_sharding._path_str(path)
        spec = jax_sharding.partition_spec_for(path_s, leaf.shape, mesh)
        axes = [i for i, a in enumerate(spec) if a is not None]
        c = 0 if not axes else 2 if axes[0] == 0 and path_s.endswith("kernel") and \
            len(leaf.shape) > 1 else 1
        return np.full(leaf.shape, c, np.float32)

    return jax.tree_util.tree_map_with_path(code, shapes)


CASES = [(f, tp) for f in ("flagship", "art", "vit_early", "vit_late", "multimodal", "hypereeg")
         for tp in (2, 4, 8)]
# Where the port replicates what JAX shards: attention modules whose heads
# do not divide tp while their width does (4 heads of width 32 at tp 8).
DIFFER = {("flagship", 8): r"(encoder\.layers\.0\.mha|cross_attn\.cross_attn)\.",
          ("art", 8): r"(mha|self_mha|cross_mha)\.",
          ("multimodal", 8): r"eeg_encoder\.(encoder\.layers\.0\.mha|cross_attn\.cross_attn)\."}


@pytest.fixture(scope="module")
def families():
    return _families()


@pytest.mark.parametrize("family,tp", CASES, ids=[f"{f}-tp{tp}" for f, tp in CASES])
def test_shard_report_matches_jax_partition_specs(families, family, tp):
    jm, inputs, conv, model = families[family]
    want = conv(_jax_codes(jm, inputs, tp))
    assert set(want) == set(model.state_dict())
    report = parallel.shard_report(model, tp)
    differ = []
    for k, codes in want.items():
        assert np.all(codes == codes.flat[0]), k  # one code a tensor
        got = 0 if k not in report else 1 if report[k].dim == 0 else 2
        if got != codes.flat[0]:
            differ.append(k)
            assert got == 0 and codes.flat[0] > 0, k  # the port only ever replicates more
    pattern = DIFFER.get((family, tp))
    if pattern is None:
        assert differ == []
    else:
        assert differ and all(re.search(pattern, k) for k in differ), differ
        assert all(k in differ for k in want
                   if re.search(pattern, k) and k.endswith(("q_proj.weight", "out_proj.weight")))
    # Every family shards something, but HyperEEG at tp 8 (no MLP rule).
    assert bool(report) != ((family, tp) == ("hypereeg", 8))
    if family == "hypereeg":  # graph.attn's 4 heads: sharded at tp 2 and 4, not at 8
        assert ("graph.attn.query.weight" in report) == (tp < 8)
        assert not any(k.startswith(("cross.", "graph.ff")) for k in report)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    r = np.random.default_rng(0)
    attn = Attention(32, 4, device=CPU)
    torch.nn.init.normal_(attn.qkv.bias, generator=torch.Generator().manual_seed(1))
    payload = {"x": r.normal(size=(5, 8)).astype(np.float32),
               "w": r.normal(size=(5, 8)).astype(np.float32),
               "attn": {k: v.detach().numpy() for k, v in attn.state_dict().items()},
               "tokens": r.normal(size=(2, 5, 32)).astype(np.float32)}
    got = parallel.launch(ranks.layer_checks, 2, payload,
                          store_dir=tmp_path_factory.mktemp("store"))
    return {"payload": payload, "ranks": got, "attn": attn}


def test_column_and_row_layers_match_dense(world2):
    p = world2["payload"]
    first, second = ranks._dense_pair(0)
    x = torch.tensor(p["x"], requires_grad=True)
    y = ranks.pair_forward(first, second, x, region=False)
    (y * torch.tensor(p["w"])).sum().backward()
    want = {"y": y.detach(), "dx": x.grad, "dw1": first.weight.grad, "db1": first.bias.grad,
            "dw2": second.weight.grad, "db2": second.bias.grad}
    for r, out in enumerate(world2["ranks"]):
        assert out["count"] == 2  # the reduce's forward, the copy's backward
        np.testing.assert_array_equal(out["w1_rows"], first.weight.detach()[6 * r:6 * (r + 1)])
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(out[k], w, rtol=0, atol=SHARE * np.abs(w).max(),
                                       err_msg=k)


def test_fused_qkv_splits_by_heads_in_each_third(world2):
    attn = world2["attn"]
    w, b = attn.qkv.weight.detach().numpy(), attn.qkv.bias.detach().numpy()
    pw = attn.proj.weight.detach().numpy()
    for r, out in enumerate(world2["ranks"]):
        assert out["attn_plan"] == ["attn"] and out["heads"] == 2
        rows = np.concatenate([np.arange(32 * third + 16 * r, 32 * third + 16 * (r + 1))
                               for third in range(3)])
        np.testing.assert_array_equal(out["qkv_weight"], w[rows])
        np.testing.assert_array_equal(out["qkv_bias"], b[rows])
        assert not np.array_equal(out["qkv_weight"], w[48 * r:48 * (r + 1)])
        np.testing.assert_array_equal(out["proj_weight"], pw[:, 16 * r:16 * (r + 1)])
        with torch.no_grad():
            want = attn(torch.tensor(world2["payload"]["tokens"])).numpy()
        np.testing.assert_allclose(out["attn_out"], want, rtol=0,
                                   atol=SHARE * np.abs(want).max())
