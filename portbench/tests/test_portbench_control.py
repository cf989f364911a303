"""The control, the plain reference at the precision below the
configuration's (float32 with TF32 matmuls and a float32 Gram, where the
configuration states float32 with TF32 off and a float64 Gram) put in the
program's place, must come out as not correct.  On the card only: TF32
exists there alone.  The training cell runs at 2^17 steps, a size a test
run holds; the serving cell at its own."""

import pytest

from portbench import calibrate, cells, compare
from portbench.tests.helpers import tiny_copy


@pytest.mark.card
@pytest.mark.parametrize("workload, n", [("dtc_m32-train-n1m", 1 << 17),
                                         ("dtc_m32-train-n10m", 1 << 17),
                                         ("eeg_m156-serve-b200", None)])
def test_control_is_not_correct(card, tmp_path, workload, n):
    cell = cells.resolve(workload, tiny_copy(tmp_path, n) if n else cells.ROOT)
    for seed in (2**33 + 1, 2**33 + 2, 2**33 + 3):
        numbers = calibrate.control(cell, seed, 0.5)
        assert not compare.verdict(numbers, cell.limits), numbers
