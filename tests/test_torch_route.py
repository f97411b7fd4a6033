"""The port's routing kernels against the JAX package's.

``route_counts`` and ``route_offsets``: the port's plain versions (what a
CPU tensor runs) against the Pallas kernel in interpret mode, as the JAX
tests run it on the CPU, and against ``ref.route_counts_ref``, exactly.
``route_pack``: against the reference route plan's own ``jnp`` lines
(``streaming/executor.py:187-207``, the one-hot cumsum and the
``.at[d, p].set`` scatter, copied below as the oracle because they live
inside the plan's step), exactly.  The Hopper kernels themselves are held
against these plain versions on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.kernels.route import route_offsets as jax_route_offsets  # noqa
from repro_torch.kernels.route import (  # noqa: E402
    CLUSTER_BLOCKS, MAX_CELLS_PER_BLOCK, MAX_DEST, pack_plan, route_counts,
    route_counts_plain, route_offsets, route_offsets_plain, route_pack,
    route_pack_plain)


def _counts_inputs(n, p, seed, lo=0, hi=None, keep=0.7):
    rng = np.random.RandomState(seed)
    pids = rng.randint(lo, p if hi is None else hi, n).astype(np.int32)
    return pids, rng.rand(n) < keep


def _port_counts(pids, valid, p):
    return route_counts(torch.from_numpy(pids), torch.from_numpy(valid),
                        p).numpy()


# test_kernels.py::test_route_counts_matches_ref's shapes
@pytest.mark.parametrize("n,p", [(512, 128), (2048, 256), (4096, 512)])
def test_route_counts_matches_jax(n, p):
    pids, valid = _counts_inputs(n, p, seed=n)
    got = _port_counts(pids, valid, p)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ops.route_counts(
        jnp.asarray(pids), jnp.asarray(valid), p)))
    np.testing.assert_array_equal(got, np.asarray(ref.route_counts_ref(
        jnp.asarray(pids), jnp.asarray(valid), p)))


# test_kernels.py::test_route_counts_property, on the port and the kernel
@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4), st.integers(1, 2), st.integers(0, 2**31 - 1))
def test_route_counts_property(n_tiles, p_tiles, seed):
    """Counts sum to the number of valid events and equal the Pallas
    kernel's."""
    n, p = 256 * n_tiles, 128 * p_tiles
    pids, valid = _counts_inputs(n, p, seed, keep=0.5)
    got = _port_counts(pids, valid, p)
    assert int(got.sum()) == int(valid.sum())
    np.testing.assert_array_equal(got, np.asarray(ops.route_counts(
        jnp.asarray(pids), jnp.asarray(valid), p)))


@pytest.mark.parametrize("n,p,lo,hi", [
    (16384, 4, 0, 4),           # the route plan's shape (P = ranks)
    (0, 3, 0, 3),               # no rows
    (1000, 7, 0, 7),            # neither a multiple of a tile
    (777, 33, -5, 40),          # pids outside [0, P) count nowhere
    (300, 1, -2, 3),
    (4096, 16384, 0, 16384),    # a key-bucket histogram
])
def test_route_counts_edges_match_ref(n, p, lo, hi):
    pids, valid = _counts_inputs(n, p, seed=p, lo=lo, hi=hi)
    got = _port_counts(pids, valid, p)
    inside = valid & (pids >= 0) & (pids < p)
    np.testing.assert_array_equal(got, np.bincount(pids[inside],
                                                   minlength=p))
    if n * p <= 2**22:
        np.testing.assert_array_equal(got, np.asarray(ref.route_counts_ref(
            jnp.asarray(pids), jnp.asarray(valid), p)))


@pytest.mark.parametrize("n,p", [(512, 128), (2048, 256), (4096, 4)])
def test_route_offsets_match_jax(n, p):
    pids, valid = _counts_inputs(n, p, seed=n + p)
    counts, offsets = route_offsets(torch.from_numpy(pids),
                                    torch.from_numpy(valid), p)
    want_c, want_o = jax_route_offsets(jnp.asarray(pids), jnp.asarray(valid),
                                       p)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(want_o))
    assert offsets.dtype == torch.int32


def test_route_offsets_plain_is_the_exclusive_prefix():
    pids, valid = _counts_inputs(1000, 9, seed=5, lo=-1, hi=11)
    counts, offsets = route_offsets_plain(torch.from_numpy(pids),
                                          torch.from_numpy(valid), 9)
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(counts.numpy())[:-1]]))


# -- route_pack ------------------------------------------------------------

def _reference_layout(ts, key, value, valid, n, K_loc, C):
    """streaming/executor.py:187-207, the route plan's send layout."""
    dest = jnp.where(valid, key // K_loc, n)
    onehot = jax.nn.one_hot(dest, n, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) - onehot)
    pos = jnp.take_along_axis(
        pos, jnp.minimum(dest, n - 1)[:, None], 1)[:, 0]
    keep = valid & (pos < C)
    n_overflow = jnp.sum(valid & ~keep, dtype=jnp.int32)
    d = jnp.where(keep, dest, n - 1)
    p = jnp.minimum(pos, C - 1)

    def scatter(x, fill):
        buf = jnp.full((n, C) + x.shape[1:], fill, x.dtype)
        return buf.at[d, p].set(jnp.where(keep, x, fill))

    return (pos, n_overflow, scatter(ts, 0), scatter(key, 0),
            scatter(value, 0.0), scatter(keep, False))


_reference_layout_jit = jax.jit(_reference_layout, static_argnums=(4, 5, 6))


def _pack_inputs(n_rows, n, k_loc, seed, oob=False, skew=None, keep=0.8):
    rng = np.random.RandomState(seed)
    K = n * k_loc
    if oob:
        key = rng.randint(-k_loc * (n + 2), k_loc * (n + 2), n_rows)
    else:
        key = rng.randint(0, K, n_rows)
    if skew is not None:            # most events to one owner
        owner = rng.randint(skew * k_loc, (skew + 1) * k_loc, n_rows)
        key = np.where(rng.rand(n_rows) < 0.8, owner, key)
    return (rng.randint(0, 10_000, n_rows).astype(np.int32),
            key.astype(np.int32), rng.randn(n_rows).astype(np.float32),
            rng.rand(n_rows) < keep)


def _assert_pack_equal(arrays, n, k_loc, cap):
    got = route_pack(*(torch.from_numpy(a) for a in arrays), n, k_loc, cap)
    pos, n_overflow, s_ts, s_key, s_val, s_ok = (
        np.asarray(x) for x in _reference_layout_jit(*arrays, n, k_loc,
                                                     cap))
    send = got.send.numpy()
    assert send.shape == (n, 4, cap) and send.dtype == np.int32
    np.testing.assert_array_equal(got.pos.numpy(), pos)
    assert int(got.n_overflow) == int(n_overflow)
    np.testing.assert_array_equal(send[:, 0], s_ts)
    np.testing.assert_array_equal(send[:, 1], s_key)
    np.testing.assert_array_equal(send[:, 2].view(np.float32), s_val)
    np.testing.assert_array_equal(send[:, 3], s_ok.astype(np.int32))
    return got, int(n_overflow)


@pytest.mark.parametrize("n_rows,n,k_loc,cap,oob,skew", [
    (16384, 4, 4096, 8192, False, None),    # the 4-rank Q5 path's shape
    (64, 4, 16, 32, False, 3),              # skew to the last shard
    (64, 4, 16, 32, False, 0),              # skew to the first
    (1000, 8, 8, 250, True, None),          # keys outside [0, K)
    (300, 3, 5, 8, True, 1),                # overflow and keys outside
    (2049, 1, 10, 4096, False, None),       # one shard; a ragged tile
    (5000, 32, 3, 20, True, None),          # the most destinations
    (0, 4, 8, 8, False, None),              # no rows
])
def test_route_pack_matches_reference_layout(n_rows, n, k_loc, cap, oob,
                                             skew):
    _assert_pack_equal(_pack_inputs(n_rows, n, k_loc, seed=n_rows + n,
                                    oob=oob, skew=skew), n, k_loc, cap)


def test_route_pack_overflow_erases_like_jax():
    """More than C events to the last destination, then rows that keep
    nothing: those write the fill over the C-th kept event's cell, in the
    reference and in the port, and only the overflow is counted."""
    n, k_loc, cap = 2, 4, 3
    key = np.array([5, 5, 5, 5, 0, 6], np.int32)         # dest 1 x 5
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    arrays = (np.arange(6, dtype=np.int32), key,
              np.arange(6, dtype=np.float32) + 1, valid)
    got, overflow = _assert_pack_equal(arrays, n, k_loc, cap)
    assert overflow == 1
    ok = got.send.numpy()[:, 3]
    assert ok[1].tolist() == [1, 1, 0]       # the 3rd kept event erased


@pytest.mark.parametrize("key,dest_cell", [
    (-1, (3, 0)),      # dest -1: column n - 1 read, cell wraps to n - 1
    (32, None),        # dest n: kept, cell outside, dropped
    (40, None),        # dest n + 1
    (-9, (2, 0)),      # dest -2 wraps to n - 2
    (-100, None),      # dest -13: the column lookup reads the fill
])
def test_route_pack_out_of_range_key(key, dest_cell):
    """One valid event with a key outside [0, K) (K 32 over 4 shards)."""
    arrays = (np.array([7], np.int32), np.array([key], np.int32),
              np.array([2.5], np.float32), np.array([True]))
    got, overflow = _assert_pack_equal(arrays, 4, 8, 8)
    assert overflow == 0
    cells = np.argwhere(got.send.numpy()[:, 3] == 1).tolist()
    assert cells == ([] if dest_cell is None else [list(dest_cell)])


@pytest.mark.parametrize("n_rows", [0, 300])
def test_route_pack_without_positions(n_rows):
    """``with_pos=False``, as the route plan calls it: the same send planes
    and overflow count, and no positions."""
    arrays = [torch.from_numpy(a)
              for a in _pack_inputs(n_rows, 3, 5, seed=4, oob=True, skew=1)]
    want = route_pack(*arrays, 3, 5, 8)
    got = route_pack(*arrays, 3, 5, 8, with_pos=False)
    assert got.pos is None and want.pos is not None
    assert torch.equal(got.send, want.send)
    assert int(got.n_overflow) == int(want.n_overflow)


def test_route_pack_rejects_bad_inputs():
    arrays = [torch.from_numpy(a) for a in _pack_inputs(10, 2, 4, seed=0)]
    with pytest.raises(ValueError, match="n_dest"):
        route_pack(*arrays, MAX_DEST + 1, 4, 8)
    with pytest.raises(ValueError, match="n_dest"):
        route_pack(*arrays, 2, 4, 0)
    with pytest.raises(TypeError, match="int32"):
        route_pack(arrays[0].long(), *arrays[1:], 2, 4, 8)
    with pytest.raises(ValueError, match="length"):
        route_pack(arrays[0][:5], *arrays[1:], 2, 4, 8)
    with pytest.raises(TypeError, match="floating"):
        route_pack(*arrays[:2], arrays[1], arrays[3], 2, 4, 8)
    with pytest.raises(ValueError, match="n_partitions"):
        route_counts(arrays[1], arrays[3], 0)


def test_plain_versions_count_no_launch():
    ts, key, value, valid = (torch.from_numpy(a)
                             for a in _pack_inputs(100, 4, 8, seed=1))
    before = (route_counts.launches, route_offsets.launches,
              route_pack.launches)
    route_counts(key, valid, 4)
    route_offsets(key, valid, 4)
    route_pack(ts, key, value, valid, 4, 8, 16)
    route_counts_plain(key, valid, 4)
    route_pack_plain(ts, key, value, valid, 4, 8, 16)
    assert (route_counts.launches, route_offsets.launches,
            route_pack.launches) == before     # CPU tensors launch nothing


# -- route_pack's cluster plan (the kernel's CPU mirror) --------------------------

@pytest.mark.parametrize("n,n_dest,cap", [
    (1, 1, 1), (1023, 4, 8), (1024, 4, 8192), (1025, 2, 300),
    (16384, 4, 8192),                   # the 4-rank Q5 path's shape
    (2**20, 8, 4096), (5000, 32, 20), (7 * 1024 + 1, 3, 1),
    (9 * 1024, 32, 12288),              # the most cells the cluster holds
])
def test_pack_plan_covers_each_row_and_cell_once(n, n_dest, cap):
    """Block b's rows [b * rows, (b + 1) * rows) and cells [b * cells, ...)
    cover every row and every send cell exactly once, in whole 1024-row
    tiles, within a block's shared memory."""
    plan = pack_plan(n, n_dest, cap)
    assert plan.blocks == CLUSTER_BLOCKS
    assert plan.rows_per_block % 1024 == 0
    rows = np.zeros(n, np.int64)
    cells = np.zeros(n_dest * cap, np.int64)
    for b in range(plan.blocks):
        rows[b * plan.rows_per_block:(b + 1) * plan.rows_per_block] += 1
        cells[b * plan.cells_per_block:(b + 1) * plan.cells_per_block] += 1
    assert (rows == 1).all() and (cells == 1).all()
    assert plan.cells_per_block <= MAX_CELLS_PER_BLOCK
    assert plan.smem_bytes == 4 * plan.cells_per_block <= 192 * 1024


@pytest.mark.parametrize("n_dest,cap", [(32, 12289), (8, 2**16), (1, 400000)])
def test_pack_plan_refuses_cells_beyond_the_cluster(n_dest, cap):
    with pytest.raises(ValueError, match="cluster's shared memory"):
        pack_plan(1000, n_dest, cap)


def test_pack_plan_refuses_rows_a_claim_cannot_name():
    with pytest.raises(ValueError, match="rows"):
        pack_plan(2**30, 4, 8)
