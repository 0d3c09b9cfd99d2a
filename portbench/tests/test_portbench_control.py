"""On the card: the control — the reference with its matrix products in
float8 e4m3, a precision below the configurations' bf16, put in the
program's place — and the DP one frame late must each come out not
correct under the committed limits, at the cells' own sizes (one seed
each; the limits were set from the readings PERF.md gives)."""

from __future__ import annotations

import pytest

from portbench import calibrate, check, manifest

SEED = 4_400_000_001


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["fp8", "dp-late"])
@pytest.mark.parametrize("cell", ["base.batch", "conformer.batch"])
def test_control_is_not_correct(card, cell, fault):
    numbers = calibrate.reference_control(cell, SEED, fault=fault)
    assert not check.verdict(numbers, manifest.limits(cell)), numbers
