"""JAX package parameters -> the port's DualEEGTransformer state_dict (numpy only).

The counterpart of ``eyegaze_tpu/models/torch_port.py::export_dual_eeg_state_dict``.
``params`` is the Flax parameter tree as nested dicts of numpy arrays; the
result maps the reference torch names to float32 numpy arrays:

- Dense kernel (in, out)        -> Linear weight (out, in)
- Conv kernel (k, in, out)      -> Conv1d weight (out, in, k)
- Conv kernel (kh, kw, in, out) -> Conv2d weight (out, in, kh, kw)
- LayerNorm scale / bias        -> weight / bias
- type_embedding (n, d)         -> (1, n, d)

Load it with ``model.load_state_dict({k: torch.from_numpy(v) ...}, strict=True)``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def dual_eeg_state_dict_from_flax(params: Mapping) -> Dict[str, np.ndarray]:
    state: Dict[str, np.ndarray] = {}

    def get(*path) -> np.ndarray:
        node = params
        for k in path:
            node = node[k]
        return np.asarray(node, dtype=np.float32)

    def put(key: str, value: np.ndarray) -> None:
        state[key] = np.ascontiguousarray(value, dtype=np.float32)

    def linear(key: str, *path) -> None:
        put(key + ".weight", get(*path, "kernel").T)
        put(key + ".bias", get(*path, "bias"))

    def norm(key: str, *path) -> None:
        put(key + ".weight", get(*path, "scale"))
        put(key + ".bias", get(*path, "bias"))

    def conv(key: str, *path) -> None:
        kernel = get(*path, "kernel")  # (k..., in, out) -> (out, in, k...)
        put(key + ".weight", np.moveaxis(kernel, (-1, -2), (0, 1)))
        put(key + ".bias", get(*path, "bias"))

    def mha(key: str, *path) -> None:
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{key}.{name}", *path, name)

    for i in range(sum(1 for k in params["temporal_conv"] if k.startswith("conv_"))):
        conv(f"temporal_conv.convs.{i}", "temporal_conv", f"conv_{i}")
    if "spectrogram_generator" in params:
        conv("spectrogram_generator.spec_conv.0", "spectrogram_generator", "conv1")
        conv("spectrogram_generator.spec_conv.3", "spectrogram_generator", "conv2")
        linear("spectrogram_generator.proj.0", "spectrogram_generator", "proj1")
        linear("spectrogram_generator.proj.3", "spectrogram_generator", "proj2")
    if "ibs_generator" in params:
        raise NotImplementedError("the legacy scalar IBS token is not ported yet")
    if "ibs_tokenizer" in params:
        if "in_scale" in params["ibs_tokenizer"]:
            put("ibs_tokenizer.instance_norm.weight", get("ibs_tokenizer", "in_scale"))
            put("ibs_tokenizer.instance_norm.bias", get("ibs_tokenizer", "in_bias"))
        linear("ibs_tokenizer.bottleneck.0", "ibs_tokenizer", "bottleneck1")
        linear("ibs_tokenizer.bottleneck.3", "ibs_tokenizer", "bottleneck2")
        put("ibs_tokenizer.type_embedding", get("ibs_tokenizer", "type_embedding")[None])
    if "ibs_classifier_1" in params:
        linear("ibs_classifier.0", "ibs_classifier_1")
        linear("ibs_classifier.3", "ibs_classifier_2")
    put("cls_token", get("cls_token"))
    put("pos_embed.pos_embed.weight", get("pos_embed", "pos_embed"))
    encoder = params["encoder"]
    for i in range(sum(1 for k in encoder if k.startswith("layer_"))):
        key, path = f"encoder.layers.{i}", ("encoder", f"layer_{i}")
        mha(f"{key}.mha", *path, "mha")
        norm(f"{key}.ln1", *path, "ln1")
        linear(f"{key}.ffn.linear1", *path, "ffn", "linear1")
        linear(f"{key}.ffn.linear2", *path, "ffn", "linear2")
        norm(f"{key}.ln2", *path, "ln2")
    norm("encoder.norm", "encoder", "norm")
    if "cross_attn" in params:
        mha("cross_attn.cross_attn", "cross_attn", "cross_attn")
        norm("cross_attn.norm", "cross_attn", "norm")
    linear("symmetric_fusion.proj", "symmetric_fusion", "proj")
    linear("classifier.0", "classifier_1")
    linear("classifier.3", "classifier_2")
    return state
