"""A run with the timed path broken underneath comes out not correct:
a step that returns its state unchanged, half of the batch left out (not
rendered, or rendered and left out of the loss), an answer altered where
it is produced, a view answered with another's map.
The harness's look for a card is skipped; the rest of a run is driven on
the CPU at a tiny size, against each cell's own limits."""

import pytest
from harness import faults, runner


@pytest.mark.parametrize("name", ["lego.train", "llff.render"])
def test_a_sound_run_is_correct(tiny, name):
    cell = tiny(name, compute_dtype="float32")
    result, lines = runner.run_cell(name, 2**33 + 1, 0.3, False, device="cpu", cell=cell)
    assert result["correct"], lines
    assert list(result)[-1] == "checks" and result["checks"]
    assert result["setup"]["built"] is False and "first_call" in result["setup"]["legs_s"]


CASES = [(name, fault) for name in ("lego.train", "llff.train")
         for fault in faults.FAULTS["train"]]
CASES += [(name, fault) for name in ("lego.render", "llff.render")
          for fault in faults.FAULTS["render"]]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_under_the_timed_path_is_not_correct(tiny, name, fault):
    cell = tiny(name, compute_dtype="float32")
    result, lines = runner.run_cell(name, 2**33 + 2, 0.3, False, device="cpu", fault=fault,
                                    cell=cell)
    assert not result["correct"], lines
