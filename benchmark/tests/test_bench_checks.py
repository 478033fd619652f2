"""The comparison that decides ``correct``, on the CPU at small sizes:
the program passes, the control (the reference at the precision below
the configuration's) fails, and so does the timed path with an answer
altered where it is produced."""

from __future__ import annotations

import pytest

from benchmark.tests.small import run, small_cell

SEED = 2**31 + 77


def _broken_run_pair(Entry, what):
    class Broken(Entry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.run_pair

            def run_pair(*args, **kw):
                res = inner(*args, **kw)
                # one row in ten altered
                if what == "disparity":
                    res.disparity[::10] += 1.0
                elif what == "depth":
                    res.depth[::10] *= 1.01
                return res

            self.run_pair = run_pair

    return Broken


@pytest.mark.parametrize("workload", ["ssd_pair_fixedF", "perceptual_rectified_pair"])
def test_program_is_correct(workload):
    r = run(small_cell(workload), SEED)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("traffic", ["", "posed_pool4"])
def test_control_is_not_correct(traffic):
    r = run(small_cell("ssd_pair_fixedF", traffic), SEED, control=True)
    assert not r["correct"]
    assert r["checks"]["disparity_mismatch_pct"]["value"] > 1.0


@pytest.mark.parametrize("what", ["disparity", "depth"])
def test_altered_answer_is_not_correct(what):
    c = small_cell("ssd_pair_fixedF")
    r = run(c, SEED, entry=_broken_run_pair(c.entry.Entry, what))
    assert not r["correct"], r["checks"]


def test_altered_disparity_is_not_correct_perceptual():
    c = small_cell("perceptual_rectified_pair")

    class Broken(c.entry.Entry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.compute_disparity

            def compute_disparity(*args):
                out = inner(*args).clone()
                out[::5] += 1.0
                return out

            self.compute_disparity = compute_disparity

    r = run(c, SEED, entry=Broken)
    assert not r["correct"], r["checks"]
