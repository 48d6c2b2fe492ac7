"""The port's tensor synthesis (clairs_to_tpu_torch/bench/synth.py) against
the JAX package's: from the same seed, byte-identical arrays and the same
generator state afterwards."""

import numpy as np
import pytest

from clairs_to_tpu.bench import synth as jsynth
from clairs_to_tpu_torch.bench import synth as tsynth


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("beta", [False, True], ids=["plain", "beta_subsample"])
@pytest.mark.parametrize("mode", ["snv", "indel"])
def test_synthesize_batch_is_byte_identical(mode, beta):
    rngs = [np.random.default_rng(11) for _ in range(2)]
    kw = dict(depth_range=(25, 95), somatic_af_range=(0.08, 0.35), mode=mode,
              beta_subsample=beta)
    want = jsynth.synthesize_batch(rngs[0], 300, **kw)
    got = tsynth.synthesize_batch(rngs[1], 300, **kw)
    _same(got, want)
    assert (want[2] >= 0).any() and (want[2] < 0).any()
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)


@pytest.mark.parametrize("mode", ["snv", "indel"])
@pytest.mark.parametrize("platform", ["ont", "ilmn"])
def test_synthesize_dual_batch_is_byte_identical(platform, mode):
    rngs = [np.random.default_rng(13) for _ in range(2)]
    want = jsynth.synthesize_dual_batch(rngs[0], 150, platform=platform, mode=mode)
    got = tsynth.synthesize_dual_batch(rngs[1], 150, platform=platform, mode=mode)
    _same(got, want)
    # the two views differ where the platform filters bases by quality
    assert (got[0] is got[1]) == (want[0] is want[1])
    if mode == "indel":
        assert set(np.unique(want[4])) & {4, 5}
    assert rngs[0].integers(1 << 30) == rngs[1].integers(1 << 30)
