"""``python -m eyegaze_tpu_torch.analyze_gaze --compare`` against the JAX
script's, on two checkpoints made as tests/test_torch_analyze_gaze.py makes
its one: the tiny early-fusion ViT ('concat') and a tiny late-fusion ViT
('full'), each exported with its meta.  The two trees are equal; each
model's directory is held as that file holds a single run; the comparison
table and the significance tests are equal to the byte where every trial of
both models clears the margin, else as floats at ``TOL``; the ranking
equals the one pandas gives the JAX table.
"""

import numpy as np
import pytest

from eyegaze_tpu_torch.analysis import MultiModelComparator
from tests.test_torch_analyze_gaze import (  # noqa: F401
    TOL,
    _one_thread,
    assert_rows_close,
    check_model_dir,
    checkpoint,
    margins,
    rows,
    run_both,
    tree,
)

SPECS = (("early", "concat", 3), ("late", "full", 4))


@pytest.fixture(scope="module")
def compare_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("analyze_gaze_compare")
    paths = [checkpoint(tmp, kind, mode, seed) for kind, mode, seed in SPECS]
    specs = [f"{kind}:{mode}" for kind, mode, _ in SPECS]
    return run_both("compare", tmp,
                    ["--compare", *(f"{s}:{ck}" for s, (ck, _) in zip(specs, paths))],
                    ["--compare", *(f"{s}:{pt}" for s, (_, pt) in zip(specs, paths))])


def test_trees_are_equal(compare_run):
    want, got, result = compare_run
    assert tree(got) == tree(want)
    assert {"early_concat/", "late_full/", "comparison_table.csv",
            "pairwise_significance.csv", "comparison_figures/radar_chart.png",
            "comparison_figures/roc_overlay.png"} <= set(tree(got))
    assert "late_full/saliency_sample.csv" not in tree(got)  # early fusion only
    assert [r.name for r in result["results"]] == ["early_concat", "late_full"]


def test_each_model_matches(compare_run):
    want, got, result = compare_run
    for (kind, mode, _), numbers in zip(SPECS, result["numbers"]):
        inside = check_model_dir(want / f"{kind}_{mode}", got / f"{kind}_{mode}", numbers)
        print(f"{kind}_{mode}: trials inside the margin: {inside} of 12")


def test_comparison_tables_match(compare_run):
    want, got, result = compare_run
    clear = all((margins(n) > 3 * TOL).all() for n in result["numbers"])
    for name in ("comparison_table.csv", "pairwise_significance.csv"):
        if clear:
            assert (got / name).read_bytes() == (want / name).read_bytes(), name
        else:
            print(f"a trial lies inside the margin: {name} compared as floats")
            assert_rows_close(rows(got / name), rows(want / name), name)


def test_ranking_is_the_pandas_order(compare_run):
    import pandas as pd

    want, _, result = compare_run
    table = pd.read_csv(want / "comparison_table.csv")
    comp = MultiModelComparator(result["results"])
    for metric in ("f1_macro", "accuracy", "recall_weighted"):
        assert comp.ranking(metric) == \
            table.sort_values(metric, ascending=False)["Model"].tolist(), metric
    np.testing.assert_allclose(
        [r["f1_macro"] for r in comp.metric_rows()], table["f1_macro"], rtol=0, atol=TOL)
