"""The comparison that decides ``correct`` in a training cell.

The program's first steps (set-up drives them through the window's own
step and loader) and the reference's steps on the same utterances and
weights each give: every step's loss, the per-leaf norms of the first
step's clipped gradient, and the per-leaf norms of each parameter's
change after the last checked step. Three numbers compare them:

- ``loss_gap``: the largest relative gap of a step's loss, and
  ``first_loss_gap`` the first step's alone;
- ``grad_norm_gap``: over the leaves, the largest gap between the
  program's norm and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
- ``update_norm_gap``: the same for the change after the last step, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf whose gradient is nought to rounding moves under
  Adam by round-off alone).

``limits/<workload>.json`` gives the limit of each number that is
compared; the run is correct when each of those lies at or below its
limit. A number without a limit is read and printed, not compared.
"""

from __future__ import annotations

import json
import os
import statistics

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("loss_gap", "first_loss_gap", "grad_norm_gap", "update_norm_gap")
# leaves whose reference gradient norm is below this share of the median
# leaf's are left out of the change
STILL_LEAF = 1e-3


def load_limits(workload: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def _worst_leaf(got: dict, want: dict, leaves) -> float:
    floor = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], floor, 1e-30) for k in leaves)


def numbers(program: dict, reference: dict) -> dict:
    """The numbers from two readings (``losses``, ``grad_norms``,
    ``change_norms``, as an architecture's ``train_steps`` gives them:
    ``reference/__init__.py``)."""
    if len(program["losses"]) != len(reference["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    gaps = [abs(p - r) / max(abs(r), 1e-30)
            for p, r in zip(program["losses"], reference["losses"])]
    grads = reference["grad_norms"]
    moving = [k for k, g in grads.items() if g >= STILL_LEAF * statistics.median(grads.values())]
    return {
        "loss_gap": max(gaps),
        "first_loss_gap": gaps[0],
        "grad_norm_gap": _worst_leaf(program["grad_norms"], grads, grads),
        "update_norm_gap": _worst_leaf(program["change_norms"], reference["change_norms"],
                                       moving),
    }


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers ``limits``
    names; a number that is not finite fails."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    if not table:
        raise ValueError("the limits name no number to compare")
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in table.values())
    return ok, table
