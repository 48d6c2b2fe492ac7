"""The port's scheduling primitives (clairs_to_tpu_torch/parallel/scheduler.py):
``owned_chunks`` and ``PrefetchPipeline`` against the JAX package's on the
same inputs, and ``init_distributed`` / ``all_hosts_barrier`` on
torch.distributed (gloo) in one process and in two real ones."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch.distributed as dist

from clairs_to_tpu.parallel import scheduler as jsched
from clairs_to_tpu_torch.parallel import scheduler as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_chunks,n_proc", [(10, 3), (4, 2), (2, 4), (0, 2), (7, 1)])
def test_owned_chunks_matches_jax(n_chunks, n_proc):
    chunks = [f"c{i}" for i in range(n_chunks)]
    parts = [tsched.owned_chunks(chunks, i, n_proc) for i in range(n_proc)]
    assert parts == [jsched.owned_chunks(chunks, i, n_proc) for i in range(n_proc)]
    assert sorted(sum(parts, [])) == sorted(chunks)
    assert parts[0] == chunks[::n_proc]


@pytest.mark.parametrize("depth,workers", [(3, 3), (1, 1), (2, 4)])
def test_prefetch_pipeline_order_matches_jax(depth, workers):
    def produce(x):
        time.sleep(0.005 * (5 - x % 5))  # out-of-order completion
        return x * x

    got = list(tsched.PrefetchPipeline(produce, range(8), depth=depth, workers=workers))
    want = list(jsched.PrefetchPipeline(produce, range(8), depth=depth, workers=workers))
    assert got == want == [(x, x * x) for x in range(8)]


def test_prefetch_pipeline_propagates_errors():
    def produce(x):
        if x == 3:
            raise ValueError("boom")
        return x

    it = iter(tsched.PrefetchPipeline(produce, range(5), depth=2, workers=2))
    assert [next(it)[1] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_single_process_touches_nothing():
    assert tsched.init_distributed(None) == (1, 0)
    assert tsched.init_distributed(None, 4, 2) == (1, 0)
    assert not dist.is_initialized()
    tsched.all_hosts_barrier("chunks_done")     # no-ops without a group
    tsched.shutdown_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,rank", [(None, 0), (2, None), (2, 2), (2, -1)])
def test_coordinator_needs_count_and_rank(n, rank):
    with pytest.raises(ValueError, match="process_id|num_processes"):
        tsched.init_distributed("127.0.0.1:1", n, rank)
    assert not dist.is_initialized()


RANK_SCRIPT = """
import datetime, sys
import torch.distributed as dist
from clairs_to_tpu_torch.parallel import scheduler
addr, rank = sys.argv[1], int(sys.argv[2])
assert scheduler.BARRIER_TIMEOUT >= datetime.timedelta(days=1)
first = scheduler.init_distributed(addr, 2, rank)
group = dist.group.WORLD
# a second request with the same flags finds the group that exists
assert scheduler.init_distributed(addr, 2, rank) == first and dist.group.WORLD is group
try:
    scheduler.init_distributed(addr, 2, 1 - rank)
except ValueError:
    pass
else:
    raise AssertionError("a process changed its rank")
scheduler.all_hosts_barrier("chunks_done")
print("RANK", *first, flush=True)
scheduler.shutdown_distributed()
assert not dist.is_initialized()
"""


def test_two_processes_get_ranks_and_pass_the_barrier():
    addr = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, addr, str(rank)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert f"RANK 2 {rank}" in out
