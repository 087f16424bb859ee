"""The comparison that decides ``correct`` for a training cell.

The program's first steps are held to the plain reference's, by the
numbers the workload file names under ``limits``:

  * ``loss_gap``: the widest relative gap of a step's loss;
  * ``grad_norm_gap``: the worst leaf's gap between the norm of the
    program's first gradient (as its optimizer got it, worked out from its
    state after one step) and the reference's;
  * ``change_norm_gap``: the worst leaf's gap between the norms of the
    parameters' change over the steps;
  * ``uplink_bytes_gap``: the uplink frame's bytes against the wire
    format's count (exact);
  * the quantizer's stage, checked by itself (``quantizer_stage``), where
    the reference follows the program's quantizer decisions.

A leaf's norm gap is |‖program‖ − ‖reference‖| over the larger of the
reference's norm of that leaf and the median leaf's. Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of both norm gaps (by that rule, not by
name).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

import torch

from fedbench.reference import pq

EXCLUDE_BELOW = 1e-3
NO_READING = 1e300


def norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in tree.items()}


def counted_leaves(ref_grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad_norms.values())
    return [k for k, v in ref_grad_norms.items() if v >= EXCLUDE_BELOW * med]


def worst_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]) -> Tuple[float, str]:
    """(the worst leaf's gap, that leaf's name)."""
    med = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def quantizer_stage(calls, num_clusters: int, iters: int) -> Dict[str, float]:
    """The quantizer's stage of the checked steps, by itself. ``calls``
    yields, for each quantize call, the program's cut grouped as its
    problems (P, N, D) in f32, its Lloyd run's f32 centroids (P, L, D),
    the codebooks it shipped (P, L, D, as f32), its codes (P, N) and the
    cut's dtype. Compared:

      * ``codes_off``: codes whose centroid is not the nearest of the
        program's own centroids, beyond a tie (exact);
      * ``codebook_cast_off``: shipped codebook values that are not the
        centroids cast to the cut's dtype (exact);
      * ``codes_differ_share``: the share of rows whose code is not the
        nearest of the reference's own centroids, seeded and iterated on
        the program's cut (a near-tie flips a few);
      * ``centroid_gap`` (read, not compared): the program's centroids
        against the reference's own, the largest difference over the
        rows' RMS, in the problems where no row's code differs. A flip in
        the last iteration's assignment that leaves every final code as
        it was still moves a centroid by about one row's share (up to
        2e-4 of the RMS at FEMNIST's cut on the card), and no fault that
        keeps every code reads more.
    """
    off = cast = differ = rows = agree = probs = 0
    gap = 0.0
    for x, cents, codebooks, codes, dtype in calls:
        off += pq.codes_off(x, cents, codes)
        cast += pq.cast_off(codebooks, cents, dtype)
        own = pq.against_own_lloyd(x, cents, codes, num_clusters, iters)
        differ += own["rows_differ"]
        rows += own["rows"]
        agree += own["problems_agree"]
        probs += own["problems"]
        gap = max(gap, own["centroid_gap"])
    return {"codes_off": float(off), "codebook_cast_off": float(cast),
            "codes_differ_share": differ / max(rows, 1),
            "centroid_gap": gap,
            "problems_agree": f"{agree}/{probs}"}


def decide(readings: Dict[str, float],
           limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every reading within its limit, the checks for the result line).
    A reading that is not a finite number (no reading: the program's
    decisions did not fit the reference's steps) is written as
    ``NO_READING`` and fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        if not math.isfinite(value):
            value = NO_READING
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks
