"""The port's L2 erasure coding against the JAX package: XOR parity and
Reed-Solomon encode/reconstruct give identical bytes for the same shards.

Below them, the non-q8 cases of the JAX package's
``tests/test_erasure_format.py`` run against ``repro_torch``, their imports
swapped (its ``test_shard_roundtrip`` is in ``test_torch_q8.py``)."""
import numpy as np
import pytest

from repro.core import erasure as jer
from repro_torch.core import concurrency as tconc
from repro_torch.core import erasure as ter
from repro_torch.kernels import ops

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis "
    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import erasure  # noqa: E402
from repro_torch.core import format as fmt  # noqa: E402


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


# ---------------------------------------------------------------------------
# GF(256) / RS
# ---------------------------------------------------------------------------


def test_gf_mul_scalar_field_axioms():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 256, 64, dtype=np.uint8)
    assert (erasure.gf_mul_scalar(v, 1) == v).all()
    assert (erasure.gf_mul_scalar(v, 0) == 0).all()
    # (a*c1)*c2 == a*(c1*c2)
    c1, c2 = 7, 211
    lhs = erasure.gf_mul_scalar(erasure.gf_mul_scalar(v, c1), c2)
    rhs = erasure.gf_mul_scalar(v, erasure._gf_mul(c1, c2))
    assert (lhs == rhs).all()


@given(st.integers(2, 6), st.integers(1, 3), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_rs_reconstruct_random_erasures(k, r, seed):
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 256, 97, dtype=np.uint8).tobytes() for _ in range(k)]
    parities = {j: p for j, p in enumerate(erasure.rs_encode(shards, r))}
    n_missing = min(r, k)
    missing = sorted(rng.choice(k, size=n_missing, replace=False).tolist())
    survivors = {i: shards[i] for i in range(k) if i not in missing}
    rec = erasure.rs_reconstruct(survivors, parities, k, missing, 97)
    for m in missing:
        assert rec[m] == shards[m], (k, r, missing)


@given(st.integers(2, 8), st.integers(0, 2**31 - 1), st.integers(10, 400))
@settings(max_examples=25, deadline=None)
def test_xor_reconstruct_any_single(k, seed, n):
    rng = np.random.default_rng(seed)
    shards = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(k)]
    parity = erasure.xor_encode(shards)
    lost = int(rng.integers(0, k))
    survivors = {i: shards[i] for i in range(k) if i != lost}
    rec = erasure.xor_reconstruct(survivors, parity, k, lost, n)
    assert rec == shards[lost]


def test_parity_home_never_self():
    for n in (4, 8, 12, 16):
        for g in (2, 4):
            ngroups = -(-n // g)
            if ngroups <= 1:
                continue
            for gid in range(ngroups):
                home = erasure.parity_home(gid, g, n)
                members = set(range(gid * g, min((gid + 1) * g, n)))
                assert home not in members, (n, g, gid)


# ---------------------------------------------------------------------------
# shard format
# ---------------------------------------------------------------------------


def test_shard_detects_corruption():
    regions = [fmt.Region("w", np.arange(1000, dtype=np.float32))]
    blob = bytearray(fmt.serialize_shard(regions, {}))
    blob[-100] ^= 0xFF  # flip a payload byte
    r = fmt.ShardReader(bytes(blob))
    assert not r.verify("w")
    with pytest.raises(IOError):
        r.read("w")


@given(st.lists(st.integers(1, 50), min_size=1, max_size=5),
       st.integers(0, 2**31 - 1))
@settings(max_examples=15, deadline=None)
def test_shard_roundtrip_property(sizes, seed):
    rng = np.random.default_rng(seed)
    regions = [fmt.Region(f"r{i}", rng.standard_normal(s).astype(np.float32))
               for i, s in enumerate(sizes)]
    r = fmt.ShardReader(fmt.serialize_shard(regions, {"n": len(sizes)}))
    for i, reg in enumerate(regions):
        np.testing.assert_array_equal(r.read(f"r{i}"), reg.array)


def test_manifest_roundtrip():
    blob = fmt.make_manifest("ck", 7, 4, level="L2",
                             shard_digests={0: "a", 3: "b"},
                             meta={"step": 7}, group_size=4)
    m = fmt.parse_manifest(blob)
    assert m["version"] == 7 and m["nranks"] == 4 and m["level"] == "L2"
    assert m["shard_digests"] == {0: "a", 3: "b"}
    assert m["complete"]
