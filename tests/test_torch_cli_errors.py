"""``clairs_to_tpu_torch run``'s exits on running out of memory against
``clairs_to_tpu run``'s: a stage of each package's ``_main_impl`` raises,
and both print the same error and return the same code, or both raise."""

import pytest

from clairs_to_tpu.cli import run as jax_run
from clairs_to_tpu_torch.cli import run as torch_run
from clairs_to_tpu_torch.parallel import scheduler

ARGV = ["-T", "tumor.bam", "-R", "ref.fa", "-p", "ont"]
ERRORS = {
    "memory_error": MemoryError(),
    "os_out_of_memory": OSError(12, "Cannot allocate memory"),
    "os_other": OSError(2, "No such file or directory"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_out_of_memory_exit_matches_jax(case, tmp_path, monkeypatch, capsys):
    error = ERRORS[case]

    def stage(args):
        raise error

    shutdowns = []
    monkeypatch.setattr(scheduler, "shutdown_distributed", lambda: shutdowns.append(1))
    outcomes = []
    for tag, module, extra in (("jax", jax_run, []), ("torch", torch_run, ["--device", "cpu"])):
        # the first stage of _main_impl
        monkeypatch.setattr(module, "resolve_af_defaults", stage)
        argv = ARGV + ["-o", str(tmp_path / tag)] + extra
        if case == "os_other":
            with pytest.raises(OSError) as e:
                module.main(argv)
            outcomes.append((type(e.value), e.value.args))
        else:
            rc = module.main(argv)
            captured = capsys.readouterr()
            outcomes.append((rc, captured.err, captured.out))
    assert outcomes[0] == outcomes[1]
    if case != "os_other":
        rc, err, out = outcomes[1]
        assert rc == 1 and err.startswith("[ERROR] Out of memory") and not out
        if case == "os_out_of_memory":
            assert err == ("[ERROR] Out of memory (OS): [Errno 12] Cannot allocate memory. "
                           "Consider smaller --chunk_size or --device_batch.\n")
    # the port leaves no process group behind, whichever way main ends
    assert shutdowns == [1]
