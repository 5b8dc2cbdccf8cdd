"""On the card, at each serving cell's own size and load: the control (the
next lower precision in the program's place) is not correct on three
seeds, and the sound program is. ``python -m pytest portbench/tests -m
cuda`` runs it there (under a minute a seed); it skips without a card;
``-s`` prints the readings."""


import pytest

from harness.check import compare, is_correct

pytestmark = pytest.mark.cuda

CELLS = ["superres_prod.ddpm25_b1", "superres_prod_int8.ddpm25_b1"]
SEEDS = [2 ** 31 + 101, 2 ** 32 + 7, 3]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, cuda_device):
    import limits

    cell, cfg = limits.cell_and_config(name, tiny=False)
    from harness import serve

    program = serve.build_program(cfg, cuda_device)
    control = None
    if cell["control"]["kind"] == "program_int8_dynamic":
        control = serve.build_program(cfg, cuda_device, "int8_dynamic")
    for seed in SEEDS:
        row = limits.readings_for_seed(cell, cfg, seed, cuda_device, program,
                                       control)
        print(name, row)
        assert is_correct(compare(row["program"], cell["limits"])), row
        assert not is_correct(compare(row["control"], cell["limits"])), row
