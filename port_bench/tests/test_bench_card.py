"""The harness on the card at sizes a test run holds: each cell's path
launches its kernels and its sampled units equal the reference. Marked
``cuda``; skips on a host without a card. Run on the card with

    python -m pytest -m cuda port_bench/tests/test_bench_card.py -q
"""

import pytest

from conftest import run_small, small_spec

# sizes at which each cell's route is the one it takes at full size: a
# chunk of >= 50 worlds takes K5r, a sheet of <= 100,000 particles K1
CARD_SIZES = {"worlds": 128, "chunk": 64, "side": 60, "frame": (64, 64),
              "big_side": 96}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["datagen4096-codec", "cloth256-sim",
                                      "cloth256-grad", "datagen4096-states"])
def test_cell_on_card(card, workload):
    out = run_small(small_spec(workload, **CARD_SIZES), device=card)
    assert out["correct"], out["checks"]
