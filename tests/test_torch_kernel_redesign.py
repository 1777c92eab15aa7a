"""The row gather with its indices in the launch parameters, and the one-pass
XOR pair: what of them runs on the CPU, bit for bit against the JAX
package (Pallas in interpret mode, as its own tests run it).

The gather's wrapper cuts an index list into launches of at most
``gather.MAX_INDICES`` (the capacity of the kernel's parameter struct);
the plain gathers over those groups, concatenated, equal the Pallas
gather of the whole list, as the launches must on the card, and the
wrapper's CPU path, one plain gather, equals it too.  The XOR pair's plain version
is held at lengths on either side of the kernel's block span.  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` phase 8)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.checksum import gather_rows_pallas
from repro.kernels.xor_parity import xor_pair_pallas
from repro_torch.core import concurrency as tconc
from repro_torch.kernels import gather as tga
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import xor_parity as txp

CAP = tga.MAX_INDICES
LENGTHS = [0, 1, CAP, CAP + 1, 3 * CAP + 5]
SPAN = txp.PAIR_BLOCK_WORDS


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


def _indices(n: int, rows: int, seed: int) -> np.ndarray:
    """``n`` row indices with repeats, the ragged last row among them."""
    idx = np.random.default_rng(seed).integers(0, rows, size=n)
    if n:
        idx[-1] = rows - 1
    if n > 2:
        idx[1] = idx[0]
    return idx


@pytest.mark.parametrize("n", LENGTHS)
def test_launch_groups_cover_the_list_in_order(n):
    groups = tga.launch_groups(n)
    assert len(groups) == -(-n // CAP)
    assert [s for s, _ in groups] == list(range(0, n, CAP))
    assert all(0 < e - s <= CAP for s, e in groups)
    assert sum(e - s for s, e in groups) == n
    if groups:
        assert groups[-1][1] == n


@pytest.mark.parametrize("n", LENGTHS)
def test_gather_over_launch_groups_matches_jax(n):
    """The plain gathers over the launch groups, concatenated, and the
    wrapper itself, equal the Pallas gather of the whole list."""
    chunk, rows = 4, 50
    words = np.random.default_rng(n).integers(
        0, 2**32, size=rows * chunk - 3, dtype=np.uint32)  # a ragged row
    padded = np.zeros(rows * chunk, np.uint32)
    padded[:words.size] = words
    padded = padded.reshape(rows, chunk)
    idx = _indices(n, rows, seed=n + 1)
    x = torch.from_numpy(words.view(np.int32))
    tpadded = torch.from_numpy(padded.view(np.int32))
    parts = [ref.gather_rows_ref(tpadded, torch.from_numpy(idx[s:e]))
             for s, e in tga.launch_groups(n)]
    got = (torch.cat(parts) if parts
           else torch.empty((0, chunk), dtype=torch.int32))
    if n:
        want = np.asarray(gather_rows_pallas(
            jnp.asarray(padded), jnp.asarray(idx.astype(np.int32)),
            interpret=True))
    else:  # a grid of no steps: nothing to gather
        want = np.zeros((0, chunk), np.uint32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    wrapped = tga.gather_rows(x, idx, chunk)
    assert wrapped.shape == (n, chunk) and wrapped.dtype == torch.int32
    np.testing.assert_array_equal(wrapped.numpy().view(np.uint32), want)


@pytest.mark.parametrize("idx", [[3], [-1], [0.5], np.array([1.0, 2.0]),
                                 torch.tensor([0], device="meta")],
                         ids=["past-last-row", "negative", "float",
                              "float-array", "not-on-host"])
def test_gather_refuses_bad_indices_on_the_host(idx):
    words = torch.arange(10, dtype=torch.int32)  # 3 rows of 4 words
    before = tga.LAUNCHES.value
    with pytest.raises(ValueError):
        tga.gather_rows(words, idx, 4)
    assert tga.LAUNCHES.value == before


@pytest.mark.parametrize("n", [1, 1001, 4099, 2 * SPAN,
                               3 * SPAN + 4 * 37 + 3])
def test_xor_pair_around_the_block_span_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    want = np.asarray(xor_pair_pallas(jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    got = txp.xor_pair(torch.from_numpy(a.view(np.int32)),
                       torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(ops.xor_pair(a, b), want)
    np.testing.assert_array_equal(want, np.asarray(jops.xor_pair(a, b)))


@pytest.mark.parametrize("form", ["list", "int64-sorted", "int32",
                                  "cpu-tensor"])
def test_gather_takes_every_host_index_form(form):
    """The capture passes sorted int64 numpy indices; a list, int32 numpy
    and a CPU tensor gather the same rows, equal to Pallas."""
    chunk, rows = 8, 20
    words = np.random.default_rng(7).integers(
        0, 2**32, size=rows * chunk - 5, dtype=np.uint32)  # a ragged row
    padded = np.zeros(rows * chunk, np.uint32)
    padded[:words.size] = words
    idx = np.sort(_indices(9, rows, seed=8))
    want = np.asarray(gather_rows_pallas(
        jnp.asarray(padded.reshape(rows, chunk)),
        jnp.asarray(idx.astype(np.int32)), interpret=True))
    given = {"list": [int(i) for i in idx], "int64-sorted": idx,
             "int32": idx.astype(np.int32),
             "cpu-tensor": torch.from_numpy(idx)}[form]
    got = tga.gather_rows(torch.from_numpy(words.view(np.int32)), given,
                          chunk)
    assert got.shape == (idx.size, chunk) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
