"""The numbers that decide ``correct``, and their judgement against limits.

Serving (``answer_gaps``): the program's answers to a seeded sample of the
window's requests against the reference's on the same request arrays, each
as a share of the root mean square of the reference's outputs over the
sample: ``answer_gap``, the largest absolute difference in any output of
any row; ``answer_rms_gap``, the root mean square of the differences; and
``answer_rms_ratio``, that root mean square over the one that the reference
itself reads with its products' operands rounded to the configuration's
stated precision: the program's gap in units of what that rounding alone
brings on the same weights and requests, which an ill-conditioned draw of
weights raises on both sides alike.

Training (``train_gaps``), over the first ``TRAIN_STEPS`` steps of the
object the window then drives:

- ``loss_gap``: the largest relative gap of a step's loss, or of one of the
  first step's loss terms;
- ``grad_gap``: the first step's clipped gradient as AdamW received it (the
  program's worked out from its first moment, m / (1 - beta1)), leaf by
  leaf: the gap between the two norms over the larger of the reference's
  norm of that leaf and the median leaf's, the worst leaf;
- ``update_gap``: the same for the norm of each leaf's change over the steps.

Leaves whose reference gradient is under a thousandth of the median leaf's
(the key projections' biases, which the softmax cancels) move by rounding
alone and are left out of both leaf gaps.
"""

from __future__ import annotations

import math
import statistics

import torch

TRAIN_STEPS = 3
NEGLIGIBLE = 1e-3


def _rms(got: list, want: list) -> float:
    return math.sqrt(sum(float(((g - w).double() ** 2).sum()) for g, w in zip(got, want))
                     / sum(w.numel() for w in want))


def answer_gaps(got: list, want: list, rounded: list | None = None) -> dict:
    """``rounded``: the reference's answers at the stated precision, where
    the configuration states one below float32."""
    scale = _rms(want, [torch.zeros_like(w) for w in want])
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    gaps = {"answer_gap": worst / scale, "answer_rms_gap": _rms(got, want) / scale}
    if rounded is not None:
        gaps["answer_rms_ratio"] = _rms(got, want) / _rms(rounded, want)
    return gaps


def loss_and_grads(fam, params: dict, cfg: dict, batch: dict, mix: dict, precision: str):
    """(loss, {term: value}, {name: gradient}) of the reference on ``batch``; a
    family with a ``ROW_BLOCK`` (a loss that is a mean over rows) runs it in
    blocks of rows."""
    rows = len(next(iter(batch.values())))
    block = getattr(fam, "ROW_BLOCK", None) or rows
    total, terms, grads = 0.0, {}, None
    for i in range(0, rows, block):
        part = {k: v[i:i + block] for k, v in batch.items()}
        share = len(next(iter(part.values()))) / rows
        loss, parts = fam.reference_loss(params, cfg, part, mix, precision)
        g = torch.autograd.grad(loss * share, list(params.values()), allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x for p, x in zip(params.values(), g)]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        total += float(loss.detach()) * share
        for k, v in parts.items():
            terms[k] = terms.get(k, 0.0) + float(v.detach()) * share
    return total, terms, dict(zip(params, grads))


def _leaf_gap(program: dict, reference: dict, leaves: list) -> float:
    median = statistics.median(reference[k] for k in leaves)
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in leaves)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def train_gaps(program: dict, ref: dict) -> dict:
    median = statistics.median(ref["grad"].values())
    leaves = [k for k, v in ref["grad"].items() if v >= NEGLIGIBLE * median]
    change = {k: float((program["after"][k].float() - ref["start"][k]).norm()) for k in leaves}
    ref_change = {k: float((ref["after"][k] - ref["start"][k]).norm()) for k in leaves}
    losses = [_rel(a, b) for a, b in zip(program["loss"], ref["loss"])]
    losses += [_rel(program["terms"][k], v) for k, v in ref["terms"].items()]
    return {
        "loss_gap": max(losses),
        "grad_gap": _leaf_gap(program["grad"], ref["grad"], leaves),
        "update_gap": _leaf_gap(change, ref_change, leaves),
    }


def judge(gaps: dict, limits: dict) -> dict:
    """{name: {value, limit, ok}} for each number that has a limit: it passes
    at or under it; a NaN, or a limited number not read, fails."""
    out = {}
    for k, limit in limits.items():
        v = gaps.get(k, float("nan"))
        out[k] = {"value": v, "limit": limit, "ok": not math.isnan(v) and v <= limit}
    return out
