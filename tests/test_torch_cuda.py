"""The port's CUDA kernel on the card: ``gru_direction`` against its plain
version, and the engine with the kernel against the engine without it.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with ``python -m pytest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from clairs_to_tpu_torch.ops import gru as tgru

pytestmark = pytest.mark.cuda
T = 33


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, H, seed, device):
    rng = np.random.default_rng(seed)
    xg = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32)).to(device)
    bound = H ** -0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, size=(H, 3 * H)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-bound, bound, size=3 * H).astype(np.float32))
    return xg, w.to(device), b.to(device)


@pytest.mark.parametrize("H", [16, 128, 192])
@pytest.mark.parametrize("B", [1000, 8192])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(cuda, H, B, reverse):
    xg, w, b = _inputs(B, H, seed=H + B, device=cuda)
    before = tgru.gru_direction.launches
    got = tgru.gru_direction(xg, w, b, reverse=reverse)
    torch.cuda.synchronize()
    assert tgru.gru_direction.launches == before + 1
    want = tgru.gru_direction_plain(xg, w, b, reverse=reverse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_bad_inputs(cuda):
    xg, w, b = _inputs(8, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        tgru.gru_direction(xg.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        tgru.gru_direction(xg[:, :, :47], w, b)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg.transpose(0, 1), w, b)
