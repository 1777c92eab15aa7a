"""The port's L2 erasure coding against the JAX package: XOR parity and
Reed-Solomon encode/reconstruct give identical bytes for the same shards."""
import numpy as np
import pytest

from repro.core import erasure as jer
from repro_torch.core import concurrency as tconc
from repro_torch.core import erasure as ter
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def port_env():
    """The port on its plain CPU versions, under its own lock checker."""
    prev = ops.get_device()
    ops.set_device("cpu")
    tconc.reset()
    tconc.enable("raise")
    yield
    leftovers = tconc.violations()
    tconc.disable()
    tconc.reset()
    ops.set_device(prev)
    assert not leftovers, "\n".join(leftovers)


def _shards(seed, k):
    rng = np.random.default_rng(seed)
    # unequal, non-multiple-of-4 lengths: the group pads to the longest
    return [rng.bytes(int(n)) for n in rng.integers(1, 5000, size=k)]


@pytest.mark.parametrize("k", [2, 4, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_xor_encode_and_reconstruct_identical(k, seed):
    shards = _shards(seed, k)
    parity = ter.xor_encode(shards)
    assert parity == jer.xor_encode(shards)
    for missing in range(k):
        survivors = {j: s for j, s in enumerate(shards) if j != missing}
        got = ter.xor_reconstruct(survivors, parity, k, missing,
                                  len(shards[missing]))
        assert got == shards[missing]
        assert got == jer.xor_reconstruct(survivors, parity, k, missing,
                                          len(shards[missing]))


@pytest.mark.parametrize("k,r", [(4, 2), (6, 3)])
def test_rs_encode_and_reconstruct_identical(k, r):
    shards = _shards(k * 10 + r, k)
    pars = ter.rs_encode(shards, r)
    assert pars == jer.rs_encode(shards, r)
    missing = list(range(r))
    survivors = {j: s for j, s in enumerate(shards) if j not in missing}
    parities = dict(enumerate(pars))
    length = max(len(s) for s in shards)
    got = ter.rs_reconstruct(survivors, parities, k, missing, length)
    assert got == jer.rs_reconstruct(survivors, parities, k, missing, length)
    for j in missing:
        assert got[j][:len(shards[j])] == shards[j]
