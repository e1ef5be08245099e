"""repro_torch's cost model against ``repro.sim.costmodel``, on the CPU.

Every priced quantity is plain Python float arithmetic in both packages,
so they must be equal (tolerance 0): ``sampling_cost``,
``surrogate_cost``, ``full_scan_cost``, ``plan_projected_cost`` (cold, and
discounted by an index's coverage through a stub with ``entries``, the
one method it reads) and ``CostRates.from_backbone`` with ``peak_flops``
given to both.  ``CostBudget`` is driven through the same ledger
sequences and must reach the same state, raising where the reference
raises.
"""
import dataclasses

import pytest

from repro.core import plan as jplan
from repro.sim import costmodel as jcost
from repro_torch.core import plan as tplan
from repro_torch.sim import costmodel as tcost

RATES = [dict(), dict(workers=4), dict(detect_fps=33.0, scan_fps=250.0, random_read_fps=80.0, workers=2)]


def _rates(pkg, kw):
    return pkg.CostRates(**kw)


@pytest.mark.parametrize("kw", RATES)
@pytest.mark.parametrize("frames", [0, 1, 450, 5000, 1_080_000])
def test_sampling_and_full_scan_equal(kw, frames):
    assert dataclasses.asdict(tcost.sampling_cost(frames, _rates(tcost, kw))) == \
        dataclasses.asdict(jcost.sampling_cost(frames, _rates(jcost, kw)))
    assert dataclasses.asdict(tcost.full_scan_cost(frames, _rates(tcost, kw))) == \
        dataclasses.asdict(jcost.full_scan_cost(frames, _rates(jcost, kw)))


@pytest.mark.parametrize("kw", RATES)
@pytest.mark.parametrize("label_fraction,train_epochs", [(0.01, 2.0), (0.05, 1.0), (0.0, 3.0)])
def test_surrogate_cost_equal(kw, label_fraction, train_epochs):
    for frames, total in ((300, 54_000), (5000, 1_200_000)):
        t = tcost.surrogate_cost(frames, total, rates=_rates(tcost, kw), label_fraction=label_fraction,
                                 train_epochs=train_epochs)
        j = jcost.surrogate_cost(frames, total, rates=_rates(jcost, kw), label_fraction=label_fraction,
                                 train_epochs=train_epochs)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.total_s, t.fixed_s) == (j.total_s, j.fixed_s)


def test_from_backbone_equal_with_peak_given():
    for flops, sur in ((1e12, None), (3.2e11, 1e9), (0.0, 5e8)):
        for peak in (197e12, 989e12):
            t = tcost.CostRates.from_backbone(flops, peak_flops=peak, mfu=0.35, workers=3,
                                              surrogate_flops_per_frame=sur)
            j = jcost.CostRates.from_backbone(flops, peak_flops=peak, mfu=0.35, workers=3,
                                              surrogate_flops_per_frame=sur)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_from_backbone_defaults_to_the_h100_bf16_peak():
    assert tcost.H100_BF16_FLOPS == 989e12
    assert tcost.CostRates.from_backbone(1e12) == tcost.CostRates.from_backbone(1e12, peak_flops=989e12)


class _Index:
    """The one method ``plan_projected_cost`` reads of an index."""

    def __init__(self, entries: dict):
        self._entries = entries

    def entries(self, version):
        return self._entries.get(version, 0)


@pytest.mark.parametrize("entries,total", [
    ({}, 54_000), ({"v1": 0}, 54_000), ({"v1": 20_000}, 54_000), ({"v1": 54_000}, 54_000),
    ({"v1": 90_000}, 54_000), ({"v2": 1_000}, 54_000), ({"v1": 20_000}, None), ({"v1": 20_000}, 0),
])
@pytest.mark.parametrize("kw", RATES)
def test_plan_projected_cost_equal(entries, total, kw):
    d = dict(queries=3, result_limit=20, max_steps=4000, cohorts=8,
             execution=dict(queries_axis=True, index=dict(detector_version="v1")))
    idx = _Index(entries)
    for plan_dict in (d, dict(d, execution=dict(queries_axis=True))):
        tp, jp = tplan.SearchPlan.from_dict(plan_dict), jplan.SearchPlan.from_dict(plan_dict)
        for index in (None, idx):
            t = tcost.plan_projected_cost(tp, _rates(tcost, kw), index=index, total_frames=total)
            j = jcost.plan_projected_cost(jp, _rates(jcost, kw), index=index, total_frames=total)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _ledger(pkg, ops):
    """Apply ``ops`` to a fresh budget: the state after each op, or the
    exception's type where it raised."""
    b = pkg.CostBudget(total_s=100.0)
    out = []
    for op, *a in ops:
        try:
            r = getattr(b, op)(*a)
            out.append((op, r, b.committed_s, b.spent_s, b.remaining_s))
        except ValueError:
            out.append((op, "ValueError", b.committed_s, b.spent_s, b.remaining_s))
    return out


@pytest.mark.parametrize("ops", [
    [("debit", 30.0), ("settle", 30.0, 10.0)],
    [("debit", 30.0), ("settle", 30.0, 10.0), ("settle", 30.0, 10.0)],        # double settle
    [("settle", 5.0, 1.0)],                                                     # never debited
    [("debit", 10.0), ("debit", 10.0), ("settle", 25.0, 5.0)],                  # beyond committed
    [("debit", 10.0), ("settle", -1.0, 0.0), ("settle", 1.0, -0.5)],            # negative amounts
    [("debit", 60.0), ("debit", 50.0), ("admits", 40.0), ("admits", 40.1)],     # refused debit
    [("debit", 0.001)] * 50 + [("settle", 0.001, 0.0005)] * 50,                # float dust
])
def test_cost_budget_same_ledger_and_raises(ops):
    assert _ledger(tcost, ops) == _ledger(jcost, ops)
