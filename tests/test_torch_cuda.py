"""The port's CUDA kernel on the card: ``gru_direction`` against its plain
version, and the engine with the kernel against the engine without it.

Marked ``cuda``; each test skips where there is no GPU.  Run them on a
machine with an H100 with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: tests/conftest.py imports jax, which that machine lacks).
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


def _inputs(B, H, seed, device, T=T):
    rng = np.random.default_rng(seed)
    xg = torch.from_numpy(rng.normal(size=(T, B, 3 * H)).astype(np.float32)).to(device)
    bound = H ** -0.5
    w = torch.from_numpy(rng.uniform(-bound, bound, size=(H, 3 * H)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-bound, bound, size=3 * H).astype(np.float32))
    return xg, w.to(device), b.to(device)


@pytest.mark.parametrize("H", [1, 16, 24, 40, 128, 192, 200, 256])
@pytest.mark.parametrize("B", [1, 63, 65, 1000, 8191, 8192])
@pytest.mark.parametrize("steps", [1, T])
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(cuda, H, B, steps, reverse):
    """Ragged last tiles (B not a multiple of 64); H not a multiple of 4
    (no 16-byte path), of 32 (the K padding) or of a 64-unit group; one
    step and the engine's 33."""
    xg, w, b = _inputs(B, H, seed=H + B, device=cuda, T=steps)
    before = tgru.gru_direction.launches
    got = tgru.gru_direction(xg, w, b, reverse=reverse)
    torch.cuda.synchronize()
    assert tgru.gru_direction.launches == before + 1
    want = tgru.gru_direction_plain(xg, w, b, reverse=reverse)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_is_deterministic(cuda):
    xg, w, b = _inputs(8191, 192, seed=3, device=cuda)
    first = tgru.gru_direction(xg, w, b)
    second = tgru.gru_direction(xg, w, b)
    assert torch.equal(first, second)


def test_kernel_rejects_bad_inputs(cuda):
    xg, w, b = _inputs(8, 16, seed=0, device=cuda)
    with pytest.raises(TypeError):
        tgru.gru_direction(xg.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        tgru.gru_direction(xg[:, :, :47], w, b)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg.transpose(0, 1), w, b)
    xg, w, b = _inputs(2, 257, seed=0, device=cuda)
    with pytest.raises(ValueError):
        tgru.gru_direction(xg, w, b)
