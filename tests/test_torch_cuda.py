"""The Hopper ``window_agg`` kernel against its plain version, on the card.

Needs a CUDA card and ``nvcc``; every test carries the ``cuda`` marker and
skips without a card.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: counts exactly (integer sums below 2^24 are exact in f32 in
any order); f32 sums ``rtol=1e-6, atol=1e-5`` (atomics add in no fixed
order); bf16 values likewise, since kernel and plain version both widen the
same bf16 values to f32 before adding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.window_agg import (  # noqa: E402
    window_agg, window_agg_into_, window_agg_plain_into_)
from repro_torch.streaming import (  # noqa: E402
    StreamExecutor, StreamJobConfig, VectorWindowSpec)

pytestmark = pytest.mark.cuda
F32_TOL = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(n, k, r, seed, device, counts=False, oob=False):
    rng = np.random.RandomState(seed)
    lo_k, hi_k, lo_r, hi_r = (-3, k + 5, -2, r + 2) if oob else (0, k, 0, r)
    arrays = (rng.randint(lo_k, hi_k, n).astype(np.int32),
              rng.randint(lo_r, hi_r, n).astype(np.int32),
              (np.ones(n) if counts else rng.randn(n)).astype(np.float32),
              rng.rand(n) > 0.2)
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n,k,r,counts,oob", [
    (65536, 16384, 1008, True, False),     # the main path's shape
    (65536, 16384, 1008, False, False),
    (1025, 129, 3, False, False),          # ragged
    (5000, 100, 6, False, True),           # keys/slots out of range
])
def test_kernel_matches_plain(cuda, n, k, r, counts, oob):
    keys, slots, vals, valid = _inputs(n, k, r, n + k, cuda, counts, oob)
    before = window_agg.launches
    panes = torch.zeros((r, k), device=cuda)
    window_agg_into_(panes, keys, slots, vals, valid)
    kr = window_agg(keys, slots, vals, valid, k, r)
    torch.cuda.synchronize()
    assert window_agg.launches == before + 2
    want = window_agg_plain_into_(torch.zeros((r, k), device=cuda), keys,
                                  slots, vals, valid)
    if counts:
        assert torch.equal(panes, want) and torch.equal(kr.t(), want)
    else:
        torch.testing.assert_close(panes, want, **F32_TOL)
        torch.testing.assert_close(kr.t(), want, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_half_values(cuda, dtype):
    keys, slots, vals, valid = _inputs(8192, 512, 16, 1, cuda)
    vals = vals.to(dtype)
    got = window_agg(keys, slots, vals, valid, 512, 16)
    want = window_agg_plain_into_(torch.zeros((16, 512), device=cuda), keys,
                                  slots, vals, valid)
    torch.testing.assert_close(got.t(), want, **F32_TOL)


def test_kernel_empty_batch_launches_nothing(cuda):
    z = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = window_agg.launches
    got = window_agg(z, z, torch.zeros(0, device=cuda),
                     torch.zeros(0, dtype=torch.bool, device=cuda), 100, 4)
    assert window_agg.launches == before
    assert got.shape == (100, 4) and not got.any()


def test_kernel_rejects_non_contiguous(cuda):
    keys, slots, vals, valid = _inputs(64, 16, 4, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        window_agg_into_(torch.zeros((16, 4), device=cuda).t(), keys, slots,
                         vals, valid)


def test_executor_on_cuda_matches_cpu(cuda):
    """One stretch of steps through both devices; the CUDA executor runs
    the kernel on every step."""
    spec = VectorWindowSpec(size_ms=100, slide_ms=10, n_key_buckets=64,
                            max_windows_per_step=4, ring_margin=8)
    cfg = StreamJobConfig(window=spec, batch_size=128)
    rng = np.random.RandomState(0)

    def gen(start, B):
        i = start // B
        return {"ts": (i * 10 + np.sort(rng.randint(0, 10, B))).astype(
                    np.int32),
                "key": rng.randint(0, 64, B).astype(np.int32),
                "value": np.ones(B, np.float32),
                "valid": rng.rand(B) > 0.1}

    batches = [gen(i * 128, 128) for i in range(60)]
    before = window_agg.launches
    gpu = StreamExecutor(cfg)
    g_state, g_res = gpu.run_stream(lambda s, B: batches[s // B], 60)
    assert window_agg.launches - before == 60
    c_state, c_res = StreamExecutor(cfg, device="cpu").run_stream(
        lambda s, B: batches[s // B], 60)
    for k in c_state:
        assert torch.equal(g_state[k].cpu(), c_state[k]), k
    assert len(g_res) == len(c_res) > 0
    for (ge, gr), (ce, cr) in zip(g_res, c_res):
        np.testing.assert_array_equal(ge, ce)
        np.testing.assert_array_equal(gr, cr)
