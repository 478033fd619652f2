"""On the card, at each cell's own size: the control (the reference at the
precision below the configuration's, in the program's place) comes out
not correct on three seeds, and the program comes out correct. Run on
the H100 with ``python -m pytest benchmark/tests/test_bench_card.py -m cuda``;
skips without a card (about 2 min)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.cuda
WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at their own sizes on the card")
    return torch.device("cuda", 0)


def _measure(workload, seed, card, control):
    c = harness.cell(harness.load_spec(), workload)
    return harness.measure(c, seed, 1.0, False, card, time.perf_counter(), control=control)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_at_the_cells_size(card, workload):
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        r = _measure(workload, seed, card, control=True)
        assert not r["correct"], (seed, r["checks"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_is_correct_at_the_cells_size(card, workload):
    r = _measure(workload, 2**31 + 404, card, control=False)
    assert r["correct"], r["checks"]
