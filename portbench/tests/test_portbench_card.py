"""The control on the card (python -m pytest portbench/tests -m card): at
the widths of the flash-single cell and a test's size (4 of the 30 GPT
layers, 16 slots, an 8 s window of the single mix), on three seeds, the
served engine passes the cell's limits and the control, the reference
through fp8 products read at the same prompts and tokens, fails one of
them."""
from __future__ import annotations

import json

import pytest

from conftest import FIXTURE
from portbench import run


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_control_fails_where_the_engine_passes(bench_root, card, seed):
    limits = json.loads((FIXTURE / "limits/card-single.json").read_text())
    res = run.run_cell(bench_root, "card-single", seed, 8.0, False, card, control=True)
    assert res["correct"] is True, res["check"]
    got = {k: v["value"] for k, v in res["check"].items()}
    assert (got["control_logit_gap"] > limits["logit_gap"]
            or got["control_wave_err"] > limits["wave_err"]), got
