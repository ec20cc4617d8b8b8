"""The harness on a card (skips without one): a short run of each cell
prints a correct result line, and the control fails its check."""

import json

import pytest

from benchmark import control, run
from benchmark.tests import small


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  small.bench()["workloads"]])
def test_a_cell_runs_on_the_card(card, cell, capsys):
    assert run.main(["--workload", cell, "--seed", "2147483701",
                     "--seconds", "2", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
def test_the_control_fails_on_the_card(card):
    numbers = control.control_numbers(small.bench(), "rig128-live",
                                      2147483702, 10.0, "cuda")
    assert any(v > 0 for v in numbers.values()), numbers
