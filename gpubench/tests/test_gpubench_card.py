"""On the card, at the cells' own size: the program's answers lie within
each cell's limits and the control's (the program on the next lower
storage type it has) do not, on three seeds.

    python -m pytest gpubench/tests -m card      # one card, a few minutes
"""

import pytest

from gpubench import calibrate
from gpubench.lib import spec

CONFIGS = sorted({w["config"] for w in spec.benchmark()["workloads"]})


@pytest.mark.card
@pytest.mark.parametrize("config", CONFIGS)
def test_control_fails_and_program_passes(cuda_card, config):
    bench = spec.benchmark()
    cfg = spec.config(config)
    cells = {w["traffic"]: w["name"] for w in bench["workloads"]
             if w["config"] == config}
    mixes = {t: spec.traffic(t) for t in cells}
    seeds = [2 ** 31 + 101 + k for k in range(3)]
    for line in calibrate.readings(cfg, mixes, seeds, 3, cuda_card,
                                   lambda m: None):
        limits = spec.load_cell(cells[line["mix"]])["limits"]
        compared = [n for n in limits if n != "failed"]
        for name in compared:
            assert line["program"][name] <= limits[name], line
        assert any(line["control"][n] > limits[n] for n in compared), line
