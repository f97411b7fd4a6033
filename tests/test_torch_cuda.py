"""The Hopper kernels against their plain versions, on the card.

Needs a CUDA card and ``nvcc``; every test carries the ``cuda`` marker and
skips without a card.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, ``window_agg``: counts exactly (integer sums below 2^24 are
exact in f32 in any order); f32 sums ``rtol=1e-6, atol=1e-5`` (atomics add
in no fixed order); bf16 values likewise, since kernel and plain version
both widen the same bf16 values to f32 before adding.  ``decode_attention``:
``2e-5`` in every type, as ``tests/test_kernels.py`` holds the Pallas
kernel to its oracle in f32 (the kernel sums in another order and scales q
where the plain version scales the scores); both sides widen the same
bf16 or f16 inputs to f32 and sum in f32, so a half type earns no wider
tolerance.  ``route_counts``, ``route_offsets`` and ``route_pack``:
integers, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import route  # noqa: E402
from repro_torch.kernels import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.route import (  # noqa: E402
    route_counts, route_counts_plain, route_offsets, route_offsets_plain,
    route_pack, route_pack_plain)
from repro_torch.kernels.window_agg import (  # noqa: E402
    window_agg, window_agg_flat_into_, window_agg_flat_plain_into_,
    window_agg_plain_into_)
from repro_torch.launch.serve import BatchedLMServer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
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
    """The op, and the flat form at accumulate's index (slot * K + key,
    a negative one wrapped by R * K) into the flattened panes."""
    keys, slots, vals, valid = _inputs(n, k, r, n + k, cuda, counts, oob)
    index = slots * k + keys
    index = torch.where(index < 0, index + r * k, index)
    before = window_agg.launches
    flat = window_agg_flat_into_(torch.zeros(r * k, device=cuda), index,
                                 vals, valid)
    kr = window_agg(keys, slots, vals, valid, k, r)
    torch.cuda.synchronize()
    assert window_agg.launches == before + 2
    want = window_agg_plain_into_(torch.zeros((r, k), device=cuda), keys,
                                  slots, vals, valid)
    want_flat = window_agg_flat_plain_into_(torch.zeros(r * k, device=cuda),
                                            index, vals, valid)
    if counts:
        assert torch.equal(flat, want_flat) and torch.equal(kr.t(), want)
    else:
        torch.testing.assert_close(flat, want_flat, **F32_TOL)
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
        window_agg_flat_into_(torch.zeros(128, device=cuda)[::2], keys, vals,
                              valid)


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


# -- decode_attention ---------------------------------------------------------

# 64-position stages; at dh 128, 3 stages in bf16/f16 (a 192-position
# ring), 2 in f32 (128 positions); 8 query rows a block
@pytest.mark.parametrize("b,h,hk,s,dh,pos,dtype", [
    (8, 12, 2, 1024, 128, 1023, "float32"),    # the serve shape, full
    (8, 12, 2, 1024, 128, 0, "float32"),
    (8, 12, 2, 1024, 128, 511, "bfloat16"),
    (1, 16, 16, 512, 128, 300, "float32"),     # G = 1
    (1, 24, 8, 640, 128, 639, "float16"),      # Hk = 8
    (2, 16, 1, 1000, 64, 2000, "float32"),     # ragged S, pos >= S, G = 16
    (3, 4, 2, 77, 16, 40, "float32"),          # a reduced model's heads
    # n_valid of 1, around one tile (= one stage) and one full ring
    (8, 12, 2, 1024, 128, 0, "bfloat16"),
    (8, 12, 2, 1024, 128, 62, "bfloat16"),
    (8, 12, 2, 1024, 128, 63, "bfloat16"),
    (8, 12, 2, 1024, 128, 64, "float16"),
    (8, 12, 2, 1024, 128, 191, "bfloat16"),
    (8, 12, 2, 1024, 128, 192, "bfloat16"),
    (8, 12, 2, 1024, 128, 62, "float32"),
    (8, 12, 2, 1024, 128, 63, "float32"),
    (8, 12, 2, 1024, 128, 64, "float32"),
    (8, 12, 2, 1024, 128, 127, "float32"),
    (8, 12, 2, 1024, 128, 128, "float32"),
    # 16 splits of 64 positions, the last split (40) ending inside a stage
    (1, 12, 2, 1000, 128, 999, "bfloat16"),
    (1, 12, 2, 1000, 128, 999, "float32"),
    # G = 1, 7 (llava-next-34b's 56 / 8), 16 and 24 (two and three row
    # groups of 8)
    (2, 16, 16, 700, 128, 650, "bfloat16"),
    (2, 56, 8, 777, 128, 776, "bfloat16"),
    (2, 56, 8, 777, 128, 776, "float32"),
    (2, 16, 1, 900, 128, 899, "bfloat16"),
    (2, 16, 1, 900, 128, 899, "float32"),
    (1, 24, 1, 500, 128, 400, "float16"),
    # dh of 16, 64 and 256 in each path
    (4, 8, 2, 600, 16, 599, "bfloat16"),
    (4, 8, 2, 600, 64, 599, "float16"),
    (4, 8, 2, 600, 64, 599, "float32"),
    (4, 8, 2, 600, 256, 599, "bfloat16"),
    (4, 8, 2, 600, 256, 599, "float32"),
    # rows TMA cannot swizzle (80 bytes): the last k-step half past dh
    (2, 8, 2, 300, 40, 299, "bfloat16"),
    (2, 8, 2, 300, 20, 299, "float32"),
    # f16 and bf16 at the serve and decode_32k widths, pos >= S
    (8, 12, 2, 1024, 128, 1500, "float16"),
    (8, 12, 2, 1024, 128, 1500, "bfloat16"),
    (2, 12, 2, 32768, 128, 40000, "bfloat16"),
    (2, 12, 2, 32768, 128, 40000, "float16"),
])
def test_decode_kernel_matches_plain(cuda, b, h, hk, s, dh, pos, dtype):
    """Through the model's seq-major cache view, read in place."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(b * h + s + pos)
    q = torch.from_numpy(rng.randn(b, h, dh).astype(np.float32)).to(cuda, dt)
    k, v = (torch.from_numpy(rng.randn(b, s, hk, dh).astype(np.float32))
            .to(cuda, dt).permute(0, 2, 1, 3) for _ in range(2))
    before = decode_attention.launches
    got = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert got.shape == (b, h, dh) and got.dtype == torch.float32
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, pos),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_twice_on_one_cache(cuda, dtype):
    """The same cache twice, then at another position: the second call
    encodes no tensor map (the cache serves it) and gives the same bits;
    the arrival counters carry nothing from one call to the next."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(8, 12, 128).astype(np.float32)).to(cuda, dt)
    k, v = (torch.from_numpy(rng.randn(8, 1024, 2, 128).astype(np.float32))
            .to(cuda, dt).permute(0, 2, 1, 3) for _ in range(2))
    first = decode_attention(q, k, v, 900)
    encoded = decode_attn.maps_encoded()
    second = decode_attention(q, k, v, 900)
    third = decode_attention(q, k, v, 300)
    torch.cuda.synchronize()
    assert decode_attn.maps_encoded() == encoded
    assert torch.equal(first, second)
    for got, pos in ((second, 900), (third, 300)):
        torch.testing.assert_close(got, decode_attention_plain(q, k, v, pos),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_k_and_v_with_different_strides(cuda, dtype):
    """k read through the seq-major cache view, v head-major and
    contiguous (and the other way round): each gets its own tensor map."""
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(4, 12, 128).astype(np.float32)).to(cuda, dt)
    seq = torch.from_numpy(rng.randn(4, 700, 2, 128).astype(np.float32)).to(
        cuda, dt).permute(0, 2, 1, 3)
    head = torch.from_numpy(rng.randn(4, 2, 700, 128).astype(np.float32)).to(
        cuda, dt)
    for k, v in ((seq, head), (head, seq)):
        before = decode_attention.launches
        got = decode_attention(q, k, v, 650)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        torch.testing.assert_close(got, decode_attention_plain(q, k, v, 650),
                                   rtol=2e-5, atol=2e-5)


def test_decode_kernel_rejects_views_tma_cannot_describe(cuda):
    """A base or a row stride off 16 bytes raises ValueError naming the
    constraint; nothing launches and nothing falls back."""
    q = torch.zeros(1, 4, 8, device=cuda)
    flat = torch.zeros(1 + 64 * 2 * 8, device=cuda)
    off = flat[1:].view(1, 64, 2, 8).permute(0, 2, 1, 3)   # base + 4 bytes
    padded = torch.zeros(1, 64, 2, 9, device=cuda)[..., :8].permute(
        0, 2, 1, 3)                                          # rows 36 bytes
    half = torch.zeros(1, 2, 64, 12, device=cuda, dtype=torch.bfloat16)
    before = decode_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q, off, off, 5)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        decode_attention(q, padded, padded, 5)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        decode_attention(torch.zeros(1, 4, 12, device=cuda,
                                     dtype=torch.bfloat16), half, half, 5)
    assert decode_attention.launches == before


def test_decode_kernel_rejects_strided_head_dim(cuda):
    q = torch.zeros(1, 4, 32, device=cuda)
    k = torch.zeros(1, 2, 64, 64, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k, k, 3)
    k18 = torch.zeros(1, 2, 8, 18, device=cuda)       # dh not a multiple of 4
    with pytest.raises(ValueError, match="multiple of 4"):
        decode_attention(torch.zeros(1, 4, 18, device=cuda), k18, k18, 3)


def test_server_on_cuda_matches_cpu(cuda):
    """A reduced qwen2 served on both devices from the same weights gives
    the same completions; every layer launches the kernel every step."""
    cfg = get_config("qwen2-1.5b").reduced()
    tree = params_to_numpy(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.RandomState(0)
    prompts = [(i, rng.randint(0, cfg.vocab_size, 8).tolist())
               for i in range(12)]

    def drain(device):
        srv = BatchedLMServer(cfg, params_from_numpy(cfg, tree, device),
                              batch_slots=4, max_seq=96, device=device)
        pending, steps = list(prompts), 0
        while pending or srv.active:
            while pending and srv.submit(*pending[0], 12):
                pending.pop(0)
            srv.step()
            steps += 1
        return [(r["id"], r["out"]) for r in srv.completed], steps

    before = decode_attention.launches
    on_card, steps = drain(cuda)
    assert decode_attention.launches - before == cfg.n_layers * steps
    assert on_card == drain("cpu")[0]


# -- route_counts, route_offsets, route_pack -----------------------------------

def _pids(n, p, seed, device, lo=0, hi=None):
    rng = np.random.RandomState(seed)
    pids = rng.randint(lo, p if hi is None else hi, n).astype(np.int32)
    return (torch.from_numpy(pids).to(device),
            torch.from_numpy(rng.rand(n) < 0.7).to(device))


@pytest.mark.parametrize("n,p,lo,hi", [
    (16384, 4, 0, 4),           # the route plan's shape: warp votes
    (512, 128, 0, 128),         # test_kernels.py's shapes: shared bins
    (2048, 256, 0, 256),
    (4096, 512, 0, 512),
    (65536, 16384, 0, 16384),   # a key-bucket histogram: global atomics
    (1000, 7, -3, 10),          # ragged, pids outside [0, P)
    (3001, 33, -1, 40),
    (5000, 12289, -9, 12300),
    (0, 5, 0, 5),               # no rows: no launch
])
def test_route_counts_kernel_matches_plain(cuda, n, p, lo, hi):
    pids, valid = _pids(n, p, n + p, cuda, lo, hi)
    before = (route_counts.launches, route_offsets.launches)
    counts = route_counts(pids, valid, p)
    c2, offsets = route_offsets(pids, valid, p)
    torch.cuda.synchronize()
    launched = 1 if n else 0
    assert (route_counts.launches, route_offsets.launches) == (
        before[0] + 2 * launched, before[1] + launched)
    want_c, want_o = route_offsets_plain(pids, valid, p)
    assert torch.equal(counts, route_counts_plain(pids, valid, p))
    assert torch.equal(counts, want_c) and torch.equal(c2, want_c)
    assert torch.equal(offsets, want_o)


def _pack_args(n_rows, n, k_loc, seed, device, oob=False, skew=None):
    rng = np.random.RandomState(seed)
    span = (-k_loc * (n + 2), k_loc * (n + 2)) if oob else (0, n * k_loc)
    key = rng.randint(*span, n_rows)
    if skew is not None:
        owner = rng.randint(skew * k_loc, (skew + 1) * k_loc, n_rows)
        key = np.where(rng.rand(n_rows) < 0.8, owner, key)
    arrays = (rng.randint(0, 10_000, n_rows).astype(np.int32),
              key.astype(np.int32), rng.randn(n_rows).astype(np.float32),
              rng.rand(n_rows) < 0.85)
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n_rows,n,k_loc,cap,oob,skew", [
    (16384, 4, 4096, 8192, False, None),    # the 4-rank Q5 path's shape
    (64, 4, 16, 32, False, 3),              # overflow to the last shard
    (1000, 8, 8, 250, True, None),          # keys outside [0, K)
    (300, 3, 5, 8, True, 1),
    (2049, 1, 10, 4096, False, None),       # one shard; a ragged tile
    (5000, 32, 3, 20, True, None),          # the most destinations
    (0, 4, 8, 8, False, None),
])
def test_route_pack_kernel_matches_plain(cuda, n_rows, n, k_loc, cap, oob,
                                         skew):
    args = _pack_args(n_rows, n, k_loc, n_rows + n, cuda, oob, skew)
    before = (route_counts.launches, route_offsets.launches,
              route_pack.launches)
    got = route_pack(*args, n, k_loc, cap)
    torch.cuda.synchronize()
    launched = 1 if n_rows else 0
    assert (route_counts.launches, route_offsets.launches,
            route_pack.launches) == tuple(b + launched for b in before)
    want = route_pack_plain(*args, n, k_loc, cap)
    assert torch.equal(got.send, want.send)
    assert torch.equal(got.pos, want.pos)
    assert int(got.n_overflow) == int(want.n_overflow)


def test_route_failed_launch_raises(cuda, monkeypatch):
    """A launch the runtime refuses (here: on a device that does not
    exist) raises, counts nothing, and falls back to nothing."""
    pids, valid = _pids(100, 4, 0, cuda)
    monkeypatch.setattr(route, "_stream", lambda t: (99, 0))
    before = route_counts.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        route_counts(pids, valid, 4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        route_pack(pids, pids, valid.float(), valid, 4, 1, 8)
    assert route_counts.launches == before


def test_route_rejects_non_contiguous(cuda):
    pids, valid = _pids(64, 4, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        route_counts(pids[::2], valid[::2], 4)
