"""JAX package parameters -> the port's state_dicts (numpy only).

The counterparts of ``eyegaze_tpu/models/torch_port.py::export_dual_eeg_state_dict``,
``export_art_state_dict``, ``export_gaze_{early,late}_state_dict`` and
``export_multimodal_state_dict``, and ``hypereeg_state_dict_from_flax``,
which has no JAX exporter: its names mirror the Flax paths.
``params`` is the Flax parameter tree as nested dicts of numpy arrays; the
result maps the reference torch names (timm's for the ViTs) to float32 numpy
arrays:

- Dense kernel (in, out)        -> Linear weight (out, in)
- Conv kernel (k, in, out)      -> Conv1d weight (out, in, k)
- Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
- LayerNorm scale / bias        -> weight / bias
- type_embedding (n, d)         -> (1, n, d)
- ART's 1x1-conv Dense (C, E)   -> Conv1d weight (E, C, 1)
- ViT attention: the per-head query / key / value kernels (E, H, hd) ->
  one timm ``qkv`` weight (3E, E), their biases (H, hd) -> (3E,); the
  ``out`` kernel (H, hd, E) -> ``proj`` weight (E, E)
- HyperEEG's attentions keep Flax's four projections: each (E, H, hd)
  ``query`` / ``key`` / ``value`` kernel -> an (E, E) weight, (H, hd) bias
  -> (E,), the (H, hd, E) ``out`` kernel -> (E, E)

Load it with ``model.load_state_dict({k: torch.from_numpy(v) ...}, strict=True)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


class _Writer:
    """Reads Flax leaves by path and writes reference-named float32 arrays."""

    def __init__(self, params: Mapping):
        self.params = params
        self.state: Dict[str, np.ndarray] = {}

    def get(self, *path) -> np.ndarray:
        node = self.params
        for k in path:
            node = node[k]
        return np.asarray(node, dtype=np.float32)

    def put(self, key: str, value: np.ndarray) -> None:
        self.state[key] = np.ascontiguousarray(value, dtype=np.float32)

    def linear(self, key: str, *path) -> None:
        self.put(key + ".weight", self.get(*path, "kernel").T)
        self.put(key + ".bias", self.get(*path, "bias"))

    def norm(self, key: str, *path) -> None:
        self.put(key + ".weight", self.get(*path, "scale"))
        self.put(key + ".bias", self.get(*path, "bias"))

    def conv(self, key: str, *path) -> None:
        kernel = self.get(*path, "kernel")  # (k..., in, out) -> (out, in, k...)
        self.put(key + ".weight", np.moveaxis(kernel, (-1, -2), (0, 1)))
        self.put(key + ".bias", self.get(*path, "bias"))

    def mha(self, key: str, *path) -> None:
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.linear(f"{key}.{name}", *path, name)

    def flax_mha(self, key: str, *path) -> None:
        """Flax's ``MultiHeadDotProductAttention`` under its own names."""
        for name in ("query", "key", "value"):
            kernel = self.get(*path, name, "kernel")  # (E, H, hd)
            self.put(f"{key}.{name}.weight", kernel.reshape(kernel.shape[0], -1).T)
            self.put(f"{key}.{name}.bias", self.get(*path, name, "bias").reshape(-1))
        kernel = self.get(*path, "out", "kernel")  # (H, hd, E)
        self.put(f"{key}.out.weight", kernel.reshape(-1, kernel.shape[-1]).T)
        self.put(f"{key}.out.bias", self.get(*path, "out", "bias"))

    def layers(self, name: str) -> range:
        return range(sum(1 for k in self.params[name] if k.startswith("layer_")))

    def encoder(self, name: str) -> None:
        for i in self.layers(name):
            key, path = f"{name}.layers.{i}", (name, f"layer_{i}")
            self.mha(f"{key}.mha", *path, "mha")
            self.norm(f"{key}.ln1", *path, "ln1")
            self.linear(f"{key}.ffn.linear1", *path, "ffn", "linear1")
            self.linear(f"{key}.ffn.linear2", *path, "ffn", "linear2")
            self.norm(f"{key}.ln2", *path, "ln2")
        self.norm(f"{name}.norm", name, "norm")

    def decoder(self, name: str) -> None:
        for i in self.layers(name):
            key, path = f"{name}.layers.{i}", (name, f"layer_{i}")
            self.mha(f"{key}.self_mha", *path, "self_mha")
            self.norm(f"{key}.ln1", *path, "ln1")
            self.mha(f"{key}.cross_mha", *path, "cross_mha")
            self.norm(f"{key}.ln2", *path, "ln2")
            self.linear(f"{key}.ffn.linear1", *path, "ffn", "linear1")
            self.linear(f"{key}.ffn.linear2", *path, "ffn", "linear2")
            self.norm(f"{key}.ln3", *path, "ln3")
        self.norm(f"{name}.norm", name, "norm")


def dual_eeg_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    w = _Writer(params)
    for i in range(sum(1 for k in params["temporal_conv"] if k.startswith("conv_"))):
        w.conv(f"temporal_conv.convs.{i}", "temporal_conv", f"conv_{i}")
    if "spectrogram_generator" in params:
        w.conv("spectrogram_generator.spec_conv.0", "spectrogram_generator", "conv1")
        w.conv("spectrogram_generator.spec_conv.3", "spectrogram_generator", "conv2")
        w.linear("spectrogram_generator.proj.0", "spectrogram_generator", "proj1")
        w.linear("spectrogram_generator.proj.3", "spectrogram_generator", "proj2")
    if "ibs_generator" in params:  # the legacy scalar IBS token
        w.linear("ibs_generator.proj.0", "ibs_generator", "proj1")
        w.linear("ibs_generator.proj.3", "ibs_generator", "proj2")
        if "norm" in params["ibs_generator"]:
            w.norm("ibs_generator.norm", "ibs_generator", "norm")
    if "ibs_tokenizer" in params:
        if "in_scale" in params["ibs_tokenizer"]:
            w.put("ibs_tokenizer.instance_norm.weight", w.get("ibs_tokenizer", "in_scale"))
            w.put("ibs_tokenizer.instance_norm.bias", w.get("ibs_tokenizer", "in_bias"))
        w.linear("ibs_tokenizer.bottleneck.0", "ibs_tokenizer", "bottleneck1")
        w.linear("ibs_tokenizer.bottleneck.3", "ibs_tokenizer", "bottleneck2")
        w.put("ibs_tokenizer.type_embedding", w.get("ibs_tokenizer", "type_embedding")[None])
    if "ibs_classifier_1" in params:
        w.linear("ibs_classifier.0", "ibs_classifier_1")
        w.linear("ibs_classifier.3", "ibs_classifier_2")
    w.put("cls_token", w.get("cls_token"))
    w.put("pos_embed.pos_embed.weight", w.get("pos_embed", "pos_embed"))
    w.encoder("encoder")
    if "cross_attn" in params:
        w.mha("cross_attn.cross_attn", "cross_attn", "cross_attn")
        w.norm("cross_attn.norm", "cross_attn", "norm")
    w.linear("symmetric_fusion.proj", "symmetric_fusion", "proj")
    w.linear("classifier.0", "classifier_1")
    w.linear("classifier.3", "classifier_2")
    return w.state


def art_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """ArtifactRemovalTransformer: the embeddings' (C, E) Dense kernels become
    Conv1d weights (E, C, 1); a learned ``pos_embed`` table is copied as is
    (the sinusoidal table is a buffer and has no parameter)."""
    w = _Writer(params)
    for side in ("src", "tgt"):
        w.put(f"{side}_embed.0.conv.weight", w.get(f"{side}_embed", "conv", "kernel").T[:, :, None])
        w.put(f"{side}_embed.0.conv.bias", w.get(f"{side}_embed", "conv", "bias"))
        if f"{side}_pos" in params:
            w.put(f"{side}_embed.1.pos_embed.weight", w.get(f"{side}_pos", "pos_embed"))
    w.encoder("encoder")
    w.decoder("decoder")
    w.linear("reconstructor.proj", "reconstructor", "proj")
    return w.state


def _vit(w: _Writer, prefix: str, *path) -> None:
    """One ViT backbone subtree at ``path`` under timm's names after
    ``prefix``."""
    tree = w.params
    for k in path:
        tree = tree[k]
    p = f"{prefix}." if prefix else ""
    w.conv(p + "patch_embed.proj", *path, "patch_embed")
    w.put(p + "cls_token", w.get(*path, "cls_token"))
    w.put(p + "pos_embed", w.get(*path, "pos_embed"))
    w.norm(p + "norm", *path, "norm")
    embed = w.get(*path, "cls_token").shape[-1]
    for i in range(sum(1 for k in tree if k.startswith("block_"))):
        b, blk = f"{p}blocks.{i}.", (*path, f"block_{i}")
        w.norm(b + "norm1", *blk, "norm1")
        w.norm(b + "norm2", *blk, "norm2")
        names = ("query", "key", "value")
        w.put(b + "attn.qkv.weight", np.concatenate(
            [w.get(*blk, "attn", n, "kernel").reshape(embed, embed).T for n in names]))
        w.put(b + "attn.qkv.bias", np.concatenate(
            [w.get(*blk, "attn", n, "bias").reshape(embed) for n in names]))
        w.put(b + "attn.proj.weight", w.get(*blk, "attn", "out", "kernel").reshape(embed, embed).T)
        w.put(b + "attn.proj.bias", w.get(*blk, "attn", "out", "bias"))
        w.linear(b + "mlp.fc1", *blk, "mlp", "fc1")
        w.linear(b + "mlp.fc2", *blk, "mlp", "fc2")
    if "head" in tree:
        w.linear(p + "head", *path, "head")


def gaze_early_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """EarlyFusionViT: the ``backbone`` ViT under ``backbone.`` (6 input
    channels for 'concat', as trained)."""
    w = _Writer(params)
    _vit(w, "backbone", "backbone")
    return w.state


def gaze_late_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """LateFusionViT: the shared ``encoder`` ViT under ``encoder.`` and the
    ``classifier``."""
    w = _Writer(params)
    _vit(w, "encoder", "encoder")
    w.linear("classifier", "classifier")
    return w.state


def multimodal_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """MultimodalFusionModel: the early-fusion ViT under ``gaze_encoder.``, the
    DualEEGTransformer under ``eeg_encoder.``, the gate's nine parameters
    under ``fusion.`` by their own names."""
    from eyegaze_tpu_torch.models.fuzzy_fusion import PARAM_NAMES

    state = {f"gaze_encoder.{k}": v
             for k, v in gaze_early_state_dict_from_flax(params["gaze_encoder"]).items()}
    state.update({f"eeg_encoder.{k}": v
                  for k, v in dual_eeg_state_dict_from_flax(params["eeg_encoder"]).items()})
    w = _Writer(params)
    for name in PARAM_NAMES:
        w.put(f"fusion.{name}", w.get("fusion", name))
    state.update(w.state)
    return state


def hypereeg_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    """HyperEEGEncoder (``models/hypereeg.py``): every Flax path becomes a
    dotted name (``temporal/sinc/low_hz`` -> ``temporal.sinc.low_hz``,
    ``graph/attn/query`` -> ``graph.attn.query.weight`` / ``.bias``); the
    modules an ablation switches off are absent in both."""
    w = _Writer(params)
    temporal = params["temporal"]
    if "sinc" in temporal:
        for name in ("low_hz", "band_hz"):
            w.put(f"temporal.sinc.{name}", w.get("temporal", "sinc", name))
    else:
        w.conv("temporal.plain_conv", "temporal", "plain_conv")
    for name in sorted(k for k in temporal if k.startswith("down_")):
        w.conv(f"temporal.{name}", "temporal", name)
    w.linear("temporal.proj", "temporal", "proj")
    if "graph" in params:
        w.flax_mha("graph.attn", "graph", "attn")
        for name in ("ln1", "ln2"):
            w.norm(f"graph.{name}", "graph", name)
        for name in ("ff1", "ff2"):
            w.linear(f"graph.{name}", "graph", name)
    if "cross" in params:
        w.flax_mha("cross.cross", "cross", "cross")
        w.norm("cross.ln", "cross", "ln")
    if "fusion" in params:
        for name in ("mu", "logvar"):
            w.linear(f"fusion.{name}", "fusion", name)
    w.linear("cls1", "cls1")
    w.linear("cls2", "cls2")
    return w.state
