"""The control of each cell, on the card at a small size: the reference
in the program's place, computed in the precision below the
configuration's, fails a limit of the cell."""

import pytest
import torch

from h100_bench import run

GENOME = run.load_json(run.BENCH, "workloads", "ont_flagship.genome_call.json")["genome"]
SMALL = {"ont_flagship.engine_stream": {"device_batch": 1024, "pool": {"snv": 2, "indel": 1}},
         "ont_flagship.train_snv": {"rows": 200, "pool": 4},
         "ont_flagship.genome_call": {"genome": dict(GENOME, genome_len=100_000, n_snv=10,
                                                     n_indel=10)}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_a_limit(cell, card, tmp_path):
    run._env()
    _man, entry, config, spec, driver = run.load_cell(cell, SMALL[cell])
    ctx = run.Ctx(entry, config, spec, 2 ** 31 + 7, 0.5, False, card)
    if cell == "ont_flagship.genome_call":
        ctx.cache = str(tmp_path)           # the small genome's files
    state = driver.setup(ctx)
    driver.window(ctx, state)
    state = driver.release(ctx, state)
    sound = {n: (v, lim) for n, v, lim in driver.check(ctx, state)}
    assert all(v <= lim for v, lim in sound.values())
    control = dict(driver.control(ctx, state))
    assert any(control[n] > spec["limits"][n] for n in control)
    torch.cuda.empty_cache()
