"""``python -m eyegaze_tpu_torch.import_torch_checkpoint`` against the JAX
package's ``scripts/import_torch_checkpoint.py``.

For each of the five kinds, a reference-layout state_dict at a non-default
geometry (the JAX ``init`` through ``torch_port.export_*_state_dict``), with
the reference's buffers added (the STFT window, sinusoidal ``pe`` tables,
the composite's ``fusion.c_reliable``), is saved bare and under each of the
three training-loop wrappers with DataParallel's ``module.`` prefix.  Both
importers read it:

- the port's meta ``config`` equals the JAX importer's;
- the port's ``best_model.pt`` equals, tensor by tensor, the JAX importer's
  orbax parameters mapped back to reference names
  (``convert.*_state_dict_from_flax``);
- both are served with ``from_checkpoint`` (bf16 on both sides) on the same
  inputs and agree within 2**-5 of the largest output, the serving bound of
  tests/test_torch_checkpoint.py, the predictions where JAX's top-two margin
  clears it; ``serve.sniff_kind`` reads the kind from the meta.

A key the port's model lacks, and a key of the model the file lacks, each
raise and name the key.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu import serving as jax_serving
from eyegaze_tpu.models import torch_port
from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.models.multimodal import MultimodalFusionModel as JaxMultimodal
from eyegaze_tpu.models.vit import EarlyFusionViT as JaxEarly
from eyegaze_tpu.models.vit import LateFusionViT as JaxLate
from eyegaze_tpu_torch import import_torch_checkpoint as importer
from eyegaze_tpu_torch import serve, serving
from eyegaze_tpu_torch.models import convert

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHARE = 2.0 ** -5
C, T, IMG = 8, 256, 64
WRAPPERS = ("bare", "state_dict", "model_state_dict", "model")

# kind -> the JAX model at a non-default geometry, its inputs, the reference
# exporter, the converter back from Flax, the importer's flags, the
# reference's buffers, the serve kind, and the (JAX, port) predictors.
VIT = dict(img_size=IMG, embed_dim=64, depth=2, num_heads=4)
ART_CONFIG = dict(in_channels=C, out_channels=C, embedding_size=32, num_encoder_layers=2,
                  num_decoder_layers=1, num_heads=4, feedforward_size=64, max_len=T,
                  recon_zscore="time")
KINDS = {
    "dual_eeg": dict(
        model=lambda: JaxDualEEG(in_channels=C, num_classes=3, d_model=32, num_layers=2,
                                 num_heads=4, d_ff=64, max_len=160, conv_kernel_size=9,
                                 conv_stride=2, ibs_feature_type="phase",
                                 ibs_instance_norm=False),
        inputs=("eeg", "eeg"), export=torch_port.export_dual_eeg_state_dict,
        convert=convert.dual_eeg_state_dict_from_flax,
        flags=["--num-heads", "4", "--conv-stride", "2", "--preprocess"],
        buffers={"spectrogram_generator.window": (128,)}, serve="eeg",
        predictors=(jax_serving.Predictor, serving.Predictor)),
    "art": dict(
        model=lambda: JaxArt(JaxArtConfig(**ART_CONFIG)), inputs=("eeg",),
        export=torch_port.export_art_state_dict, convert=convert.art_state_dict_from_flax,
        flags=["--num-heads", "4", "--recon-zscore", "time"],
        buffers={"src_embed.1.pe": (1, T, 32), "tgt_embed.1.pe": (1, T, 32)}, serve="art",
        predictors=(jax_serving.ArtDenoiser, serving.ArtDenoiser)),
    "gaze_early": dict(
        model=lambda: JaxEarly(num_classes=3, fusion_mode="concat", **VIT),
        inputs=("img", "img"), export=torch_port.export_gaze_early_state_dict,
        convert=convert.gaze_early_state_dict_from_flax, flags=[], buffers={}, serve="gaze",
        predictors=(jax_serving.GazePredictor, serving.GazePredictor)),
    "gaze_late": dict(
        model=lambda: JaxLate(num_classes=3, fusion_mode="multiply", **VIT),
        inputs=("img", "img"), export=torch_port.export_gaze_late_state_dict,
        convert=convert.gaze_late_state_dict_from_flax, flags=["--fusion-mode", "multiply"],
        buffers={}, serve="gaze",
        predictors=(jax_serving.GazePredictor, serving.GazePredictor)),
    "multimodal": dict(
        model=lambda: JaxMultimodal(num_classes=3, fuzzy_mode="no_temperature",
                                    eeg_in_channels=C, eeg_d_model=32, eeg_num_layers=1,
                                    eeg_num_heads=4, eeg_d_ff=64, eeg_max_len=128,
                                    vit_embed_dim=64, vit_depth=2, vit_num_heads=4,
                                    img_size=IMG),
        inputs=("img", "img", "eeg", "eeg"), export=torch_port.export_multimodal_state_dict,
        convert=convert.multimodal_state_dict_from_flax,
        flags=["--num-heads", "4", "--fuzzy-mode", "no_temperature"],
        buffers={"fusion.c_reliable": (), "eeg_encoder.spectrogram_generator.window": (128,)},
        serve="multimodal",
        predictors=(jax_serving.MultimodalPredictor, serving.MultimodalPredictor)),
}
_CACHE: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_importer():
    spec = importlib.util.spec_from_file_location(
        "jax_import_torch_checkpoint", ROOT / "scripts" / "import_torch_checkpoint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _request(kind: str, n: int, seed: int) -> list:
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8) if x == "img"
            else (r.normal(size=(n, C, T)) * 10.0).astype(np.float32)
            for x in KINDS[kind]["inputs"]]


def _served(outs: dict) -> np.ndarray:
    return outs["logits"] if "logits" in outs else outs["denoised"]


def _reference(kind: str, tmp: Path) -> dict:
    """The reference state_dict of ``kind``, the JAX importer's result and
    the JAX predictor's answer to a request (computed once a kind)."""
    if kind in _CACHE:
        return _CACHE[kind]
    spec = KINDS[kind]
    model = spec["model"]()
    zeros = [jnp.zeros((1, 3, IMG, IMG) if x == "img" else (1, C, T), jnp.float32)
             for x in spec["inputs"]]
    params = jax.jit(model.init)(jax.random.PRNGKey(3), *zeros)["params"]
    state = {k: np.asarray(v) for k, v in spec["export"](params).items()}
    r = np.random.default_rng(0)
    for k, shape in spec["buffers"].items():
        state[k] = r.normal(size=shape).astype(np.float32)
    bare = tmp / f"{kind}_bare.pt"
    torch.save({k: torch.from_numpy(v.copy()) for k, v in state.items()}, bare)
    out = tmp / f"{kind}_jax"
    assert _jax_importer().main([str(bare), "--out", str(out)] + spec["flags"]) == 0
    import orbax.checkpoint as ocp

    jax_params = ocp.StandardCheckpointer().restore((out / "best_model").absolute())["params"]
    jpred = spec["predictors"][0].from_checkpoint(out / "best_model", batch_buckets=(2, 4))
    request = _request(kind, 3, 11)
    _CACHE[kind] = {
        "state": state, "meta": json.loads((out / "best_model.meta.json").read_text()),
        "weights": spec["convert"](jax.tree_util.tree_map(np.asarray, jax_params)),
        "request": request, "answer": jpred.predict(*request),
    }
    return _CACHE[kind]


def _save(state: dict, path: Path, wrapper: str) -> Path:
    tensors = {k: torch.as_tensor(np.array(v)) for k, v in state.items()}
    if wrapper != "bare":
        tensors = {f"module.{k}": v for k, v in tensors.items()}
        tensors = {wrapper: tensors, "epoch": 3}
    torch.save(tensors, path)
    return path


def check_import(kind: str, wrapper: str, tmp_path_factory) -> None:
    """Both importers on ``kind``'s reference file saved with ``wrapper``;
    the module docstring says what is held."""
    ref = _reference(kind, tmp_path_factory.mktemp("ref"))
    tmp = tmp_path_factory.mktemp(f"{kind}_{wrapper}")
    src = _save(ref["state"], tmp / "reference.pt", wrapper)
    out = tmp / "imported"
    assert importer.main([str(src), "--out", str(out)] + KINDS[kind]["flags"]) == 0
    meta = json.loads((out / "best_model.meta.json").read_text())
    assert meta["config"] == ref["meta"]["config"]
    assert meta["imported_from"] == str(src)
    got = torch.load(out / "best_model.pt", weights_only=True)
    assert set(got) == set(ref["weights"])
    for k, want in ref["weights"].items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
    assert serve.sniff_kind(out / "best_model.pt") == KINDS[kind]["serve"]

    pred = KINDS[kind]["predictors"][1].from_checkpoint(out / "best_model.pt", device=CPU,
                                                        batch_buckets=(2, 4))
    answer = pred.predict(*ref["request"])
    want, have = _served(ref["answer"]), _served(answer)
    tol = SHARE * np.abs(want).max()
    assert have.shape == want.shape and tol > 0
    np.testing.assert_allclose(have, want, rtol=0, atol=tol)
    if "preds" in answer:
        top2 = np.sort(want, axis=-1)
        clear = top2[:, -1] - top2[:, -2] > tol
        np.testing.assert_array_equal(answer["preds"][clear], ref["answer"]["preds"][clear])


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_import_matches_the_jax_importer(wrapper, tmp_path_factory):
    """The flagship (its ART, gaze and composite cases are in
    tests/test_torch_import_checkpoint_{models,composite}.py, which spreads
    the JAX importer's eager inits over the lane's workers)."""
    check_import("dual_eeg", wrapper, tmp_path_factory)


def _small_state(kind: str) -> dict:
    """A reference state_dict of ``kind`` without JAX: the port's own model
    at the test geometry, which uses the reference's names."""
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
    from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
    from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT

    g = dict(device=CPU, generator=torch.Generator().manual_seed(0))
    model = {
        "dual_eeg": lambda: DualEEGTransformer(in_channels=C, d_model=32, num_layers=1,
                                               num_heads=4, d_ff=64, **g),
        "art": lambda: ArtifactRemovalTransformer(ArtConfig(**ART_CONFIG), **g),
        "gaze_early": lambda: EarlyFusionViT(**VIT, **g),
        "gaze_late": lambda: LateFusionViT(fusion_mode="full", **VIT, **g),
        "multimodal": lambda: MultimodalFusionModel(
            eeg_in_channels=C, eeg_d_model=32, eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=64,
            vit_embed_dim=64, vit_depth=2, vit_num_heads=4, img_size=IMG, **g),
    }[kind]()
    return dict(model.state_dict())


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_stray_key_raises_and_names_it(kind, tmp_path):
    state = _small_state(kind)
    state["head_extra.weight"] = torch.zeros(3)
    src = _save(state, tmp_path / "stray.pt", "model_state_dict")
    with pytest.raises(ValueError, match=r"keys the model lacks \['head_extra.weight'\]"):
        importer.main([str(src), "--out", str(tmp_path / "out"), "--kind", kind])
    assert not (tmp_path / "out" / "best_model.pt").exists()


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_missing_key_raises_and_names_it(kind, tmp_path):
    state = _small_state(kind)
    gone = [k for k in state if k.endswith(".bias")][-1]
    del state[gone]
    src = _save(state, tmp_path / "missing.pt", "state_dict")
    with pytest.raises(ValueError, match=rf"keys the checkpoint lacks \['{gone}'\]"):
        importer.main([str(src), "--out", str(tmp_path / "out"), "--kind", kind])


def test_the_reference_buffers_are_dropped_and_only_they(tmp_path):
    """The five buffer suffixes and the composite's ``fusion.c_reliable``
    are dropped; ``c_reliable`` outside the composite is a stray key."""
    assert all(importer.is_buffer(f"a.b{s}", "dual_eeg") for s in importer.BUFFER_SUFFIXES)
    assert importer.is_buffer("fusion.c_reliable", "multimodal")
    assert not importer.is_buffer("fusion.c_reliable", "dual_eeg")
    assert not importer.is_buffer("encoder.layers.0.ln1.weight", "dual_eeg")
    state = _small_state("dual_eeg")
    state["ibs_tokenizer.instance_norm.running_mean"] = torch.zeros(C * C)
    state["ibs_tokenizer.instance_norm.num_batches_tracked"] = torch.tensor(4)
    src = _save(state, tmp_path / "with_stats.pt", "model")
    assert importer.main([str(src), "--out", str(tmp_path / "out")]) == 0
    got = torch.load(tmp_path / "out" / "best_model.pt", weights_only=True)
    assert not any(k.endswith(("running_mean", "num_batches_tracked")) for k in got)
    pred = serving.Predictor.from_checkpoint(tmp_path / "out" / "best_model.pt", device=CPU)
    assert pred.model.in_channels == C
