"""The port's ``window_agg`` against the JAX package's Pallas kernel.

Both sides get the same numpy inputs (``RandomState(seed)``).  The JAX
kernel runs as the JAX tests run it on the CPU, in interpret mode; the
port runs on CPU tensors, i.e. its plain PyTorch version (the Hopper
kernel itself is held against that plain version on the card, in
``test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances: float32 sums of random values ``rtol=1e-6, atol=1e-5``, as
``tests/test_kernels.py`` holds the Pallas kernel to its oracle (the two
sum in different orders); bf16 values ``rtol=2e-2``; counts exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.streaming.window import (  # noqa: E402
    VectorWindowSpec as JaxSpec, accumulate as jax_accumulate,
    window_state_init as jax_state_init)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.window_agg import (  # noqa: E402
    window_agg, window_agg_into_, window_agg_plain_into_)
from repro_torch.streaming.window import (  # noqa: E402
    VectorWindowSpec, accumulate, window_state_init)

F32_TOL = dict(rtol=1e-6, atol=1e-5)

# test_kernels.py::test_window_agg_matches_ref and
# test_device_window.py::test_window_agg_kernel_pads_non_tile_shapes
SHAPES = [(256, 128, 8), (1024, 256, 16), (2048, 512, 4), (512, 128, 32),
          (1000, 100, 8), (1500, 200, 5), (3, 7, 4), (1025, 129, 3)]


def _inputs(n, k, r, seed, key_lo=0, key_hi=None, slot_lo=0, slot_hi=None):
    rng = np.random.RandomState(seed)
    keys = rng.randint(key_lo, k if key_hi is None else key_hi, n)
    slots = rng.randint(slot_lo, r if slot_hi is None else slot_hi, n)
    return (keys.astype(np.int32), slots.astype(np.int32),
            rng.randn(n).astype(np.float32), rng.rand(n) > 0.2)


def _jax(keys, slots, vals, valid, k, r, dtype=jnp.float32):
    return np.asarray(ops.window_agg(
        jnp.asarray(keys), jnp.asarray(slots),
        jnp.asarray(vals).astype(dtype), jnp.asarray(valid), k, r))


def _port(keys, slots, vals, valid, k, r, dtype=torch.float32):
    return window_agg(torch.from_numpy(keys), torch.from_numpy(slots),
                      torch.from_numpy(vals).to(dtype),
                      torch.from_numpy(valid), k, r).numpy()


@pytest.mark.parametrize("n,k,r", SHAPES)
def test_window_agg_matches_jax(n, k, r):
    args = _inputs(n, k, r, seed=n + k)
    got = _port(*args, k, r)
    assert got.shape == (k, r) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax(*args, k, r), **F32_TOL)


def test_window_agg_counts_exact():
    keys, slots, _, valid = _inputs(4096, 256, 16, seed=3)
    ones = np.ones(4096, np.float32)
    np.testing.assert_array_equal(_port(keys, slots, ones, valid, 256, 16),
                                  _jax(keys, slots, ones, valid, 256, 16))


def test_window_agg_empty_batch():
    z = np.zeros(0, np.int32)
    args = (z, z, np.zeros(0, np.float32), np.zeros(0, bool))
    got = _port(*args, 100, 4)
    assert got.shape == (100, 4) and not got.any()
    np.testing.assert_array_equal(got, _jax(*args, 100, 4))


def test_window_agg_drops_out_of_range_and_invalid():
    """Keys outside [0, K) and slots outside [0, R) match no one-hot column
    in the TPU kernel; invalid rows carry value 0.  All contribute 0."""
    k, r = 100, 6
    args = _inputs(3000, k, r, seed=11, key_lo=-5, key_hi=k + 40,
                   slot_lo=-3, slot_hi=r + 3)
    got = _port(*args, k, r)
    np.testing.assert_allclose(got, _jax(*args, k, r), **F32_TOL)
    keys, slots, vals, valid = args
    inside = valid & (keys >= 0) & (keys < k) & (slots >= 0) & (slots < r)
    np.testing.assert_allclose(got.sum(), vals[inside].sum(), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_window_agg_value_dtypes(dtype):
    keys, slots, vals, valid = _inputs(512, 128, 8, seed=7)
    got = _port(keys, slots, vals, valid, 128, 8,
                dtype=getattr(torch, dtype))
    want = _jax(keys, slots, vals, valid, 128, 8,
                dtype=getattr(jnp, dtype))
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_window_agg_into_matches_transposed():
    """The in-place (R, K) form adds what the (K, R) form returns."""
    k, r = 129, 7
    keys, slots, vals, valid = (torch.from_numpy(a) for a in
                                _inputs(2000, k, r, seed=5))
    base = torch.from_numpy(np.random.RandomState(6).randn(r, k)
                            .astype(np.float32))
    panes = base.clone()
    out = window_agg_into_(panes, keys, slots, vals, valid)
    assert out is panes
    kr = window_agg(keys, slots, vals, valid, k, r)
    np.testing.assert_allclose(panes.numpy(), (base + kr.t()).numpy(),
                               **F32_TOL)


def test_window_agg_rejects_bad_inputs():
    keys = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones(8)
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        window_agg(keys.long(), keys, vals, valid, 4, 4)
    with pytest.raises(TypeError):
        window_agg(keys, keys, vals.double(), valid, 4, 4)
    with pytest.raises(ValueError):
        window_agg(keys, keys[:4], vals, valid, 4, 4)
    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        window_agg(meta, meta, vals.to("meta"), valid.to("meta"), 4, 4)


def test_plain_version_counts_no_launch():
    keys, slots, vals, valid = (torch.from_numpy(a) for a in
                                _inputs(64, 16, 4, seed=1))
    before = window_agg.launches
    window_agg_plain_into_(torch.zeros(4, 16), keys, slots, vals, valid)
    window_agg(keys, slots, vals, valid, 16, 4)
    assert window_agg.launches == before       # CPU tensors launch nothing


@pytest.mark.parametrize("valued", [False, True])
def test_streaming_accumulate_kernel_consistency(valued):
    """The port's accumulate and its kernel agree on pane content, and both
    equal the JAX accumulate (test_kernels.py's consistency check)."""
    kw = dict(size_ms=60, slide_ms=10, n_key_buckets=128, ring_margin=10)
    spec, jspec = VectorWindowSpec(**kw), JaxSpec(**kw)
    rng = np.random.RandomState(0)
    n = 256
    ts = np.sort(rng.randint(0, 120, n)).astype(np.int32)
    keys = rng.randint(0, 128, n).astype(np.int32)
    vals = (rng.randn(n) if valued else np.ones(n)).astype(np.float32)
    valid = np.ones(n, bool)
    t = [torch.from_numpy(a) for a in (ts, keys, vals, valid)]
    state = accumulate(spec, window_state_init(spec, device="cpu"), *t)
    slots = (t[0] // spec.slide_ms) % spec.ring_len
    got = window_agg(t[1], slots.to(torch.int32), t[2], t[3], 128,
                     spec.ring_len)
    np.testing.assert_allclose(state["panes"].numpy(), got.t().numpy(),
                               **F32_TOL)
    jstate = jax_accumulate(jspec, jax_state_init(jspec), *(
        jnp.asarray(a) for a in (ts, keys, vals, valid)))
    np.testing.assert_allclose(state["panes"].numpy(),
                               np.asarray(jstate["panes"]), **F32_TOL)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_named_by_source_hash():
    """One library per csrc/*.cu under the git-ignored build directory,
    named by a hash of its source so an edited kernel is rebuilt."""
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == ["window_agg"]
    path = _build.library_path("window_agg")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert path.name.startswith("window_agg-") and path.suffix == ".so"
    assert path == _build.library_path("window_agg")
