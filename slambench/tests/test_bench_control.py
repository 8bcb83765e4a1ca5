"""The controls come out as not correct.

On the CPU at a small size: the plain reference of the feature front
computed in bfloat16, put in the program's place on the window's sampled
frames, fails the feature numbers. On the card, at the cell's own size
(marked ``cuda``): the program with its own TF32 path switched on fails
the numbers past the feature front."""

import pytest
import torch

from bench_small import small_cell
from slambench import cell as cells
from slambench import checks, run


def test_bfloat16_reference_fails_the_feature_numbers():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        res = run.run_cell(small_cell("tsukuba.track"), 2_900_000_101, 5.0,
                           False, "cpu", control=True)
    finally:
        torch.set_num_threads(n)
    control = res["numbers"].control
    limit = checks.LIMITS["kp_miss"][0]
    assert res["numbers"]["kp_miss"] <= limit
    assert control["kp_miss"] > 3 * max(limit, 1e-3)


@pytest.mark.cuda
def test_tf32_program_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists on the card alone")
    cell = cells.resolve("tsukuba.track")
    seconds = float(cells.load_json(cells.BENCHMARK)["run_seconds"])
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        res = run.run_cell(cell, 2_900_000_202, seconds, False, "cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert not res["correct"], dict(res["numbers"])
