"""The port's q8 compression against the JAX package: the plain quantize and
dequantize versions bit for bit against the jitted ``repro.kernels.ops``
(Pallas in interpret mode on the CPU) — codes, scales and restored values,
ragged counts and NaN, ±inf and all-zero blocks included; q8 shards
byte-identical and read by either package; q8 checkpoints restored across
the packages both ways; and the JAX package's q8 behaviour tests
(``test_kernels``, ``test_erasure_format``, ``test_system``,
``test_property_roundtrip``) with their imports swapped.  The CUDA kernels
themselves run only on the card and are held against the same plain
versions by ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import smoke_config as jax_smoke_config
from repro.core import format as jfmt
from repro.kernels import ops as jops
from repro.kernels.quantize import dequantize_pallas, quantize_pallas
from repro.train.steps import init_train_state as jax_init
import repro_torch.core as tcore
from repro_torch.configs import smoke_config
from repro_torch.core import concurrency as tconc
from repro_torch.core import format as tfmt
from repro_torch.core.capture import leaves_with_paths
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tqz
from repro_torch.kernels import ref
from repro_torch.kernels import xor_parity as txp
from repro_torch.train.steps import init_train_state, state_from_numpy

NRANKS = 4
NAME = "ckpt"


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


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


def _values(seed: int, n: int, dtype) -> np.ndarray:
    """Seeded normal values with a NaN block, a zero block and ±inf blocks
    where ``n`` has room for them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(dtype)
    for block, val in ((1, np.nan), (3, 0.0), (5, np.inf), (6, -np.inf)):
        if block * 256 + 256 <= n:
            if val == 0.0:
                x[block * 256:block * 256 + 256] = 0
            else:
                x[block * 256 + 7] = val
    return x


# ---------------------------------------------------------------------------
# plain versions against the jitted JAX quantize / dequantize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("n", [1, 255, 257, 2048, 70_001])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_matches_jitted_jax(seed, n, dtype):
    x = _values(seed, n, dtype)
    jq, js, jn, jshape = jops.quantize(x)
    q, s, tn, tshape = ops.quantize(x)
    assert (tn, tshape) == (jn, jshape)
    assert q.dtype == np.int8 and q.shape == jq.shape == (-(-n // 256), 256)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(_bits(s), _bits(js))
    want = jops.dequantize(jq, js, jn, jshape)
    got = ops.dequantize(q, s, tn, tshape)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_non_finite_blocks_restore_as_nan():
    x = _values(2, 7 * 256, np.float32)
    q, s, n, shape = ops.quantize(x)
    assert _bits(s[1]) == 0x7FC00000 and np.isinf(s[5]) and np.isinf(s[6])
    for b in (1, 5, 6):
        assert (q[b] == 0).all()
        back = ops.dequantize(q, s, n, shape)[b * 256:(b + 1) * 256]
        assert np.isnan(back).all()
    assert (q[3] == 0).all() and s[3] == np.float32(1e-30) * np.float32(
        ref.INV_127)


def test_wrappers_take_ragged_counts_without_padding():
    """``quantize.quantize`` takes the (n,) values; the codes of the last
    block's missing values are 0 and ``dequantize`` writes n values."""
    x = torch.from_numpy(_values(3, 300, np.float32))
    q, s = tqz.quantize(x)
    assert q.shape == (2, 256) and s.shape == (2,)
    assert (q[1, 300 - 256:] == 0).all()
    back = tqz.dequantize(q, s, 300)
    assert back.shape == (300,)
    np.testing.assert_array_equal(
        back.numpy(), ref.dequantize_ref(q, s).reshape(-1)[:300].numpy())
    with pytest.raises(ValueError):
        tqz.dequantize(q, s, 600)  # 3 blocks' worth from 2
    with pytest.raises(ValueError):
        tqz.quantize(x.view(10, 30))


@pytest.mark.parametrize("n", [1, 300, 512])
def test_quantize_flat_ref_is_the_padded_plain_version(n):
    """The one plain entry point for (n,) values: ``quantize_ref`` of the
    values zero-padded to whole blocks, and what the wrapper returns."""
    x = torch.from_numpy(_values(4, n, np.float32))
    padded = torch.zeros(-(-n // 256) * 256)
    padded[:n] = x
    want = ref.quantize_ref(padded.view(-1, 256))
    for got in (ref.quantize_flat_ref(x), tqz.quantize(x)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


def test_cpu_versions_launch_nothing_and_ops_count_dispatches():
    counters = (tqz.LAUNCHES, tqz.DEQUANT_LAUNCHES, txp.PAIR_LAUNCHES)
    before = [c.value for c in counters]
    disp = dict(ops.KERNEL_DISPATCHES)
    q, s, n, shape = ops.quantize(np.ones(1000, np.float32))
    ops.dequantize(q, s, n, shape)
    ops.xor_pair(np.ones(5, np.uint32), np.ones(5, np.uint32))
    assert [c.value for c in counters] == before
    for key in ("quantize", "dequantize", "xor_pair"):
        assert ops.KERNEL_DISPATCHES[key] == disp[key] + 1


# ---------------------------------------------------------------------------
# ported from tests/test_kernels.py (q8 sweeps)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,bs", [(32, 256), (64, 256), (32, 512)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_quantize_kernel_vs_ref(rows, bs, dtype):
    """The port's plain versions against the Pallas kernels, exact (the JAX
    test allows ±1 code and rtol 1e-6 between its kernel and its eager
    oracle, which divides where the jitted kernel multiplies)."""
    rng = np.random.default_rng((rows, bs, dtype().itemsize))
    x = (rng.standard_normal((rows, bs)) * 3).astype(dtype)
    q, s = quantize_pallas(jnp.asarray(x), interpret=True)
    qr, sr = ref.quantize_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(qr.numpy(), np.asarray(q))
    np.testing.assert_array_equal(_bits(sr.numpy()), _bits(np.asarray(s)))
    back = dequantize_pallas(q, s, interpret=True)
    br = ref.dequantize_ref(qr, sr)
    np.testing.assert_array_equal(_bits(br.numpy()), _bits(np.asarray(back)))


#: (n, seed) draws, as the JAX property test draws them, where the error
#: exceeds ``s/2 + 1e-7`` by 0.9e-7 to 2.7e-7: two f32 roundings, not a
#: fault of the quantizer.
_BREAKING_DRAWS = [(3144, 1028060167), (5000, 256), (4999, 277), (4096, 256)]


def _roundtrip_draw(case):
    """The 15 seeded draws (n from the seed) and the breaking draws."""
    kind, a = case
    if kind == "seed":
        rng = np.random.default_rng(a)
        n = int(rng.integers(10, 5001))
    else:
        n, seed = a
        rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * rng.uniform(0.1, 10)).astype(np.float32)


@pytest.mark.parametrize(
    "case", [("seed", s) for s in range(15)]
    + [("draw", d) for d in _BREAKING_DRAWS],
    ids=[f"seed{s}" for s in range(15)]
    + [f"n{n}-seed{s}" for n, s in _BREAKING_DRAWS])
def test_quantize_roundtrip_error_bound(case):
    """Property: block-int8 quantization error <= scale/2 per element, plus
    what the two f32 roundings add.  ``fl(x/s)`` is within ``|x/s| 2^-24``
    of ``x/s``, so ``q = rint(fl(x/s))`` is within ``1/2 + |x/s| 2^-24``
    and ``q*s`` within ``s/2 + |x| 2^-24`` of ``x``; ``fl(q*s)`` adds at
    most ``|q*s| 2^-24 <= (|x| + s/2) 2^-24``.  The sum is under the
    asserted ``s/2 (1 + 2^-23) + |x| 2^-23``, computed in f64."""
    x = _roundtrip_draw(case)
    q, s, n_out, shape = ops.quantize(x)
    back = ops.dequantize(q, s, n_out, shape)
    eps = 2.0 ** -23
    s64 = np.repeat(s.astype(np.float64), 256)[:x.size]
    x64 = x.astype(np.float64)
    bound = s64 * 0.5 * (1 + eps) + np.abs(x64) * eps
    assert (np.abs(back.astype(np.float64) - x64) <= bound).all()


def test_quantize_preserves_shape_dtype_meta():
    x = np.random.default_rng(42).standard_normal((7, 13, 3)).astype(
        np.float32)
    q, s, n, shape = ops.quantize(x)
    back = ops.dequantize(q, s, n, shape)
    assert back.shape == x.shape
    assert np.abs(back - x).max() < 0.5


# ---------------------------------------------------------------------------
# q8 shards: byte-identical, read by either package
# ---------------------------------------------------------------------------


def _arrays():
    rng = np.random.default_rng(13)
    return {
        "big": rng.standard_normal((40, 77)).astype(np.float32),  # ragged
        "half": (rng.standard_normal(1500) * 4).astype(np.float16),
        "small": rng.standard_normal((3, 5)).astype(np.float32),  # < 1024
        "step": np.asarray(7, np.int32),
        "bf16": rng.integers(0, 2**16, size=(40, 40), dtype=np.uint16),
    }


def _jax_regions():
    a = _arrays()
    return [jfmt.Region(k, v.view(ml_dtypes.bfloat16) if k == "bf16" else v)
            for k, v in a.items()]


def _port_regions(form):
    a = _arrays()
    if form == "numpy":
        return [tfmt.Region(k, v, dtype="bfloat16" if k == "bf16" else None)
                for k, v in a.items()]
    out = []
    for k, v in a.items():
        t = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) \
            if k == "bf16" else torch.from_numpy(v)
        out.append(tfmt.Region(k, t))
    return out


@pytest.mark.parametrize("form", ["tensor", "numpy"])
def test_q8_shard_bytes_identical(form):
    want = jfmt.serialize_shard(_jax_regions(), {"v": 1}, encoding="q8")
    got = tfmt.serialize_shard(_port_regions(form), {"v": 1}, encoding="q8")
    assert got == want
    encodings = {e["name"]: e["encoding"]
                 for e in tfmt.ShardReader(got).header["regions"]}
    assert encodings == {"big": "q8", "half": "q8", "small": "raw",
                         "step": "raw", "bf16": "raw"}


def test_readers_read_each_others_q8_shards():
    jblob = jfmt.serialize_shard(_jax_regions(), {"v": 1}, encoding="q8")
    tblob = tfmt.serialize_shard(_port_regions("tensor"), {"v": 1},
                                 encoding="q8")
    jr, tr = jfmt.ShardReader(tblob), tfmt.ShardReader(jblob)
    for name in ("big", "half", "small", "step"):
        assert tr.verify(name)
        got, want = tr.read(name), jr.read(name)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name
    bf = tr.read("bf16")
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.view(torch.int16).numpy(),
                                  np.asarray(jr.read("bf16")).view(np.int16))


@pytest.mark.parametrize("encoding", ["raw", "zlib", "q8"])
def test_shard_roundtrip(encoding):
    """Ported from tests/test_erasure_format.py."""
    rng = np.random.default_rng(0)
    regions = [
        tfmt.Region("w", rng.standard_normal((33, 7)).astype(np.float32)),
        tfmt.Region("b", rng.integers(0, 100, 11).astype(np.int32)),
        tfmt.Region("big", rng.standard_normal(5000).astype(np.float32)),
    ]
    blob = tfmt.serialize_shard(regions, {"step": 5}, encoding=encoding)
    r = tfmt.ShardReader(blob)
    assert r.meta == {"step": 5}
    assert set(r.region_names) == {"w", "b", "big"}
    for reg in regions:
        got = r.read(reg.name)
        if encoding == "q8" and reg.array.dtype.kind == "f" \
                and reg.array.size >= 1024:
            assert np.abs(got - reg.array).max() < 0.1  # lossy
        else:
            np.testing.assert_array_equal(got, reg.array)


@pytest.mark.parametrize("seed", range(10))
def test_shard_roundtrip_q8_lossy_bounded(seed):
    """Ported from tests/test_property_roundtrip.py on seeded numpy draws
    (one case per seed): q8 round-trip stays within one quantization step
    of the block absmax."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1024, 4097))
    arr = rng.uniform(-1e6, 1e6, n).astype(np.float32)
    blob = tfmt.serialize_shard([tfmt.Region("r", arr)], {}, encoding="q8")
    out = tfmt.ShardReader(blob).read("r")
    assert out.shape == arr.shape
    step = np.abs(arr).max() / 127.0 + 1e-6
    assert np.abs(out - arr).max() <= step * 1.01


# ---------------------------------------------------------------------------
# q8 checkpoints through the client, across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rank_states():
    """Per rank, a flat ``{path: numpy leaf}`` quarter of the JAX smoke
    train state (leaves dealt round-robin in path order)."""
    state = jax_init(jax.random.PRNGKey(0),
                     jax_smoke_config("veloc-demo-100m"))
    leaves = [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path), np.asarray(leaf))
              for path, leaf in jax.tree_util.tree_leaves_with_path(state)]
    return [dict(leaves[r::NRANKS]) for r in range(NRANKS)]


_PKG = {"jax": jcore, "torch": tcore}


def _input(pkg, state):
    return state if pkg == "jax" else state_from_numpy(state, "cpu")


def _checkpoint(pkg, scratch, states):
    core = _PKG[pkg]
    cfg = core.VelocConfig(scratch=str(scratch), mode="sync", encoding="q8")
    cluster = core.Cluster(cfg, nranks=NRANKS)
    clients = [core.VelocClient(cfg, cluster, rank=r) for r in range(NRANKS)]
    futs = [c.checkpoint(_input(pkg, states[r]), version=1)
            for r, c in enumerate(clients)]
    for f in futs:
        assert not f.module_errors, f.module_errors
    for c in clients:
        c.shutdown()
    return cluster


def _restore(pkg, scratch, state, rank):
    core = _PKG[pkg]
    cfg = core.VelocConfig(scratch=str(scratch), mode="sync", encoding="q8")
    client = core.VelocClient(cfg, core.Cluster(cfg, nranks=NRANKS),
                              rank=rank)
    version, got = client.restart_latest(_input(pkg, state))
    assert version == 1, client.restart_diagnostics
    client.shutdown()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in got.items()}


def test_q8_checkpoints_identical_and_restore_across_packages(
        tmp_path, rank_states):
    shards = {}
    for pkg in _PKG:
        cluster = _checkpoint(pkg, tmp_path / pkg, rank_states)
        shards[pkg] = [cluster.fetch_shard(NAME, 1, r) for r in range(NRANKS)]
    assert shards["torch"] == shards["jax"]
    assert any(e["encoding"] == "q8" for e in tfmt.ShardReader(
        shards["torch"][0]).header["regions"])
    for r in range(NRANKS):
        # each package reads the other's checkpoint, in a fresh cluster
        got = {(w, rd): _restore(rd, tmp_path / w, rank_states[r], r)
               for w, rd in (("torch", "jax"), ("jax", "torch"),
                             ("jax", "jax"))}
        for k, live in rank_states[r].items():
            want = got[("jax", "jax")][k]
            for key in (("torch", "jax"), ("jax", "torch")):
                assert got[key][k].dtype == want.dtype
                assert got[key][k].shape == want.shape
                assert got[key][k].tobytes() == want.tobytes(), (key, k)
            if live.dtype.kind == "f" and live.size >= 1024:
                # half the largest block scale, and its rounding
                bound = np.abs(live).max() / 127.0 * 0.5 * 1.001 + 1e-7
                assert np.abs(want - live).max() <= bound, k
            else:
                np.testing.assert_array_equal(want, live)


def test_quantized_checkpoint_restores_close(tmp_path):
    """Ported from tests/test_system.py."""
    cfg = smoke_config("veloc-demo-100m")
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")
    vc = tcore.VelocConfig(scratch=str(tmp_path), mode="sync", partner=False,
                           xor_group=0, encoding="q8")
    c = tcore.VelocClient(vc)
    c.checkpoint(state, version=1)
    v, restored = c.restart_latest(state)
    assert v == 1
    want = leaves_with_paths(state["params"])
    got = leaves_with_paths(restored["params"])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(want, got):
        a, b = a.float().numpy(), b.float().numpy()
        scale = max(np.abs(a).max(), 1e-6)
        assert np.abs(a - b).max() / scale < 0.02
    c.shutdown()
