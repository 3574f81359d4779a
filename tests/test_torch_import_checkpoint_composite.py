"""``import_torch_checkpoint`` against the JAX importer for the multimodal
composite (its ``fusion.c_reliable`` buffer dropped, its constructor's
fields stamped under ``model.multimodal``): what
tests/test_torch_import_checkpoint.py holds for the flagship."""

import pytest

from tests.test_torch_import_checkpoint import WRAPPERS, _one_thread, check_import  # noqa: F401


@pytest.mark.parametrize("wrapper", WRAPPERS)
@pytest.mark.parametrize("kind", ["multimodal"])
def test_import_matches_the_jax_importer(kind, wrapper, tmp_path_factory):
    check_import(kind, wrapper, tmp_path_factory)
