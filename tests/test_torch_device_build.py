"""A model built on the card equals the same model built on the CPU and
moved there: the parameters come from the CPU generator, and every
non-persistent buffer (the spectrogram's Hann window, the positional
tables, the sinc bank's window) is computed on the CPU and copied, so the
two forwards agree to the bit, and a checkpoint served by
``from_checkpoint`` (built on the CPU) answers as the trainer that wrote it
(built on the card).  Needs the card; run it there with
``python3 -m pytest tests/test_torch_device_build.py -q -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch.models.hypereeg import create_hypereeg_model
from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel

TINY = dict(img_size=64, vit_embed_dim=64, vit_depth=1, vit_num_heads=4, eeg_d_model=64,
            eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=128, eeg_max_len=512)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it compares a model built on the card")


def _both(build):
    card = build(torch.device("cuda")).eval()
    moved = build(torch.device("cpu")).to("cuda").eval()
    for (name, a), (_, b) in zip(card.named_buffers(), moved.named_buffers()):
        assert torch.equal(a, b), name
    for (name, a), (_, b) in zip(card.named_parameters(), moved.named_parameters()):
        assert torch.equal(a, b), name
    return card, moved


@pytest.mark.cuda
def test_composite_built_on_the_card_equals_one_moved_there():
    _needs_card()
    card, moved = _both(lambda dev: MultimodalFusionModel(
        **TINY, device=dev, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    r = np.random.default_rng(0)
    x = [torch.from_numpy(r.normal(size=s).astype(np.float32)).cuda()
         for s in ((2, 3, 64, 64), (2, 3, 64, 64), (2, 32, 1024), (2, 32, 1024))]
    with torch.inference_mode():
        a, b = card(*x), moved(*x)
    for k in ("logits", "img_logits", "eeg_logits", "alpha"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_hypereeg_built_on_the_card_equals_one_moved_there():
    _needs_card()
    card, moved = _both(lambda dev: create_hypereeg_model(
        "full", "documented", device=dev, generator=torch.Generator().manual_seed(0),
        dtype=torch.bfloat16))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 32, 1024)).astype(
        np.float32)).cuda()
    with torch.inference_mode():
        assert torch.equal(card(x, x)["logits"], moved(x, x)["logits"])
