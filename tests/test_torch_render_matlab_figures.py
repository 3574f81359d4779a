"""``python -m eyegaze_tpu_torch.render_matlab_figures`` against the JAX
package's ``scripts/render_matlab_figures.py``: the entropy suite over
tests/test_matlab_parity.py's ``entropy_tree`` (the suites themselves are
held in tests/test_torch_matlab_parity*.py), a suite whose inputs are
missing skipped, the exit codes and the bad-suite error."""

import importlib.util
from pathlib import Path

import pytest

from eyegaze_tpu_torch import render_matlab_figures
from tests.test_matlab_parity import ENTROPY_ARTIFACTS
from tests.test_torch_matlab_parity import assert_same_artifacts, build_entropy_tree

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location(
        "jax_render_matlab_figures", ROOT / "scripts" / "render_matlab_figures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _outputs(out, root) -> list:
    """The printed lines, with the output root written as <out>."""
    return [line.replace(str(root), "<out>") for line in out.splitlines()]


def test_cli_matches(tmp_path, capsys):
    tree, _ = build_entropy_tree(tmp_path / "entropy")
    argv = ["--result-dir", str(tree), "--suites", "entropy,gradcam"]
    assert _script().main(argv + ["--output-dir", str(tmp_path / "jax")]) == 0
    want = _outputs(capsys.readouterr().out, tmp_path / "jax")
    assert render_matlab_figures.main(argv + ["--output-dir", str(tmp_path / "port")]) == 0
    got = _outputs(capsys.readouterr().out, tmp_path / "port")
    assert got == want
    assert any(line.startswith("[figures] gradcam: skipped") for line in got)
    names = {p.name for p in (tmp_path / "port" / "entropy_native").iterdir()}
    assert names == {p.name for p in (tmp_path / "jax" / "entropy_native").iterdir()}
    assert names <= ENTROPY_ARTIFACTS and "fig_eeg_raincloud.png" in names
    assert_same_artifacts({n: tmp_path / "port" / "entropy_native" / n for n in names},
                          {n: tmp_path / "jax" / "entropy_native" / n for n in names})


def test_nothing_rendered_and_bad_suites(tmp_path, capsys):
    argv = ["--result-dir", str(tmp_path), "--suites", "ibs,attention"]
    assert _script().main(argv) == 1
    want = _outputs(capsys.readouterr().out, tmp_path)
    assert render_matlab_figures.main(argv) == 1
    assert _outputs(capsys.readouterr().out, tmp_path) == want
    with pytest.raises(SystemExit):
        render_matlab_figures.main(["--result-dir", str(tmp_path), "--suites", "ibs,nope"])
    assert "unknown suites ['nope']" in capsys.readouterr().err
