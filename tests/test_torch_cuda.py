"""The Hopper kernels against their plain versions, on the card.

Needs a CUDA card and ``nvcc``; every test carries the ``cuda`` marker and
skips without a card.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances, ``window_agg`` and ``accumulate``: counts exactly (integer
sums below 2^24 are exact in f32 in any order); f32 sums ``rtol=1e-6,
atol=1e-5`` (atomics add in no fixed order); bf16 and f16 values likewise,
since kernel and plain version both widen the same values to f32 before
adding.  ``accumulate``'s frames, counters and watermark: exactly.  ``decode_attention``:
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
    pack_cluster, pack_plan, route_counts, route_counts_plain, route_offsets,
    route_offsets_plain, route_pack, route_pack_plain)
from repro_torch.kernels.window_agg import (  # noqa: E402
    accumulate_, accumulate_plain_, window_agg, window_agg_plain_into_)
from repro_torch.launch.serve import BatchedLMServer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
from repro_torch.nexmark import NexmarkGenerator  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    StreamExecutor, StreamJobConfig, VectorWindowSpec)
from repro_torch.streaming.window import window_state_init  # noqa: E402

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
    """The op into its (K, R) output."""
    keys, slots, vals, valid = _inputs(n, k, r, n + k, cuda, counts, oob)
    before = window_agg.launches
    kr = window_agg(keys, slots, vals, valid, k, r)
    torch.cuda.synchronize()
    assert window_agg.launches == before + 1
    want = window_agg_plain_into_(torch.zeros((r, k), device=cuda), keys,
                                  slots, vals, valid)
    if counts:
        assert torch.equal(kr.t(), want)
    else:
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
    keys, slots, vals, valid = _inputs(128, 16, 4, 0, cuda)
    before = (window_agg.launches, accumulate_.launches)
    with pytest.raises(ValueError, match="contiguous"):
        window_agg(keys[::2], slots[::2], vals[::2], valid[::2], 16, 4)
    spec, state, calls, _ = _acc_case("two_frames_one_slot", cuda)
    (ts, key, value, ok), _ = calls[0]
    wide = torch.stack([ts, ts], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        accumulate_(state, wide, key, value, ok, **_acc_kw(spec))
    assert (window_agg.launches, accumulate_.launches) == before


def test_executor_on_cuda_matches_cpu(cuda):
    """One stretch of steps through both devices; the CUDA executor runs
    the accumulate kernel on every step.  Then the route plan's accumulate
    inputs through the kernel."""
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
    before = (window_agg.launches, accumulate_.launches)
    gpu = StreamExecutor(cfg)
    g_state, g_res = gpu.run_stream(lambda s, B: batches[s // B], 60)
    assert (window_agg.launches, accumulate_.launches) == (before[0],
                                                           before[1] + 60)
    c_state, c_res = StreamExecutor(cfg, device="cpu").run_stream(
        lambda s, B: batches[s // B], 60)
    for k in c_state:
        assert torch.equal(g_state[k].cpu(), c_state[k]), k
    assert len(g_res) == len(c_res) > 0
    for (ge, gr), (ce, cr) in zip(g_res, c_res):
        np.testing.assert_array_equal(ge, ce)
        np.testing.assert_array_equal(gr, cr)
    _route_inputs_through_the_kernel(cuda)


def _route_inputs_through_the_kernel(cuda):
    """What the route plan hands accumulate (a rank's received planes: ts,
    key less the rank's first bucket, the value's bits as float32, ok !=
    0), through the kernel, against the plain version on the CPU."""
    spec = VectorWindowSpec(size_ms=100, slide_ms=10, n_key_buckets=64,
                            max_windows_per_step=4, ring_margin=8)
    n, k_loc, cap, rank = 4, 16, 40, 1
    loc = VectorWindowSpec(size_ms=100, slide_ms=10, n_key_buckets=k_loc,
                           max_windows_per_step=4, ring_margin=8)
    rng = np.random.RandomState(3)
    states = {d: {k: v.to(d) for k, v in
                  window_state_init(loc, device="cpu").items()}
              for d in (cuda, "cpu")}
    for step in range(20):
        b = 128
        arrays = ((step * 10 + np.sort(rng.randint(0, 10, b))).astype(
                      np.int32),
                  rng.randint(0, spec.n_key_buckets, b).astype(np.int32),
                  rng.randn(b).astype(np.float32), rng.rand(b) > 0.1)
        for d, state in states.items():
            ts, key, value, valid = (torch.from_numpy(a).to(d)
                                     for a in arrays)
            send = route_pack(ts, key, value, valid, n, k_loc, cap).send
            planes = send[rank]                       # (4, C) from one source
            before = accumulate_.launches
            accumulate_(state, planes[0], planes[1] - rank * k_loc,
                        planes[2].view(torch.float32), planes[3] != 0,
                        **_acc_kw(loc))
            assert accumulate_.launches == before + (d == cuda)
    for k, v in states["cpu"].items():
        got = states[cuda][k].cpu()
        if k == "panes":
            torch.testing.assert_close(got, v, **F32_TOL)
        else:
            assert torch.equal(got, v), k


# -- accumulate ---------------------------------------------------------------
#: the paper's Q5 (chip_smoke.py): R = 1 000 + 8 slots of 16 384 buckets
Q5 = VectorWindowSpec(size_ms=10_000, slide_ms=10, n_key_buckets=16_384,
                      max_windows_per_step=8, ring_margin=8)
#: a small ring, so that one batch spans it more than twice
SMALL = VectorWindowSpec(size_ms=80, slide_ms=10, n_key_buckets=512,
                         ring_margin=8)


def _acc_kw(spec):
    return dict(slide_ms=spec.slide_ms,
                frames_per_window=spec.frames_per_window, wm_lag=spec.wm_lag,
                frontier_from_data=spec.frontier_from_data)


def _acc_case(name, device):
    """``(spec, state, [((ts, key, value, valid), wm_hint), ...], exact)``
    on ``device``: exact where every value is a count."""
    rng = np.random.RandomState(sum(map(ord, name)))
    spec = SMALL
    if name.startswith("q5"):
        spec = Q5
    elif name == "no_frontier_wm_lag":
        spec = VectorWindowSpec(size_ms=80, slide_ms=10, n_key_buckets=512,
                                ring_margin=8, wm_lag=25,
                                frontier_from_data=False)
    R, K = spec.ring_len, spec.n_key_buckets
    state = {"panes": np.zeros((R, K), np.float32),
             "slot_frame": np.full(R, -1, np.int32),
             "watermark": np.int32(-1), "next_emit": np.int32(-1),
             "dropped_late": np.int32(0), "dropped_conflict": np.int32(0)}

    def rows(ts, key, valid=None, value=None, dtype=torch.float32):
        n = len(ts)
        arrays = (np.asarray(ts, np.int32), np.asarray(key, np.int32),
                  np.ones(n, np.float32) if value is None
                  else np.asarray(value, np.float32),
                  np.ones(n, bool) if valid is None
                  else np.asarray(valid, bool))
        t = [torch.from_numpy(a).to(device) for a in arrays]
        t[2] = t[2].to(dtype)
        return tuple(t)

    def mixed(n, counts, dtype=torch.float32):
        # frames 0..40 over 16 slots: frames share slots in the batch, the
        # state's occupants conflict, frames below 7 are late, keys run
        # past both ends of [0, K)
        state["slot_frame"][:] = np.where(rng.rand(R) < 0.5,
                                          np.arange(R) + R, -1)
        state["next_emit"] = np.int32(150)
        state["watermark"] = np.int32(149)
        state["panes"] = rng.randint(0, 4, (R, K)).astype(np.float32)
        state["dropped_late"] = np.int32(2)
        key = rng.randint(-20, K + 40, n)
        key[:3] = [-1, K, K + 17]
        return rows(rng.randint(0, 410, n), key, rng.rand(n) < 0.9,
                    None if counts else rng.randn(n), dtype)

    exact = True
    if name.startswith("q5"):
        # step 7 of the stream: frames 0..6 are in the ring already
        gen = NexmarkGenerator(rate=65_536 * 100, n_keys=10_000)
        blk = gen.gen_block(np.arange(7 * 65_536, 8 * 65_536))
        state["slot_frame"][:7] = np.arange(7)
        state["panes"][:7] = rng.randint(0, 3, (7, K))
        state["next_emit"] = np.int32(10)
        state["watermark"] = np.int32(69)
        prices = name == "q5_step_prices"
        exact = not prices
        calls = [(rows(blk.ts, blk.key % K, blk.cols["kind"] == 2,
                       blk.value if prices else None), None)]
    elif name == "two_frames_one_slot":
        # frames 2 and 18 share slot 2, empty on entry: both go live
        calls = [(rows([25, 185, 27, 183, 21], [1, 2, 1, 4, 9]), None)]
    elif name == "conflicts":
        state["slot_frame"][[2, 5]] = [2, 21]
        state["next_emit"] = np.int32(30)
        calls = [(rows([25, 185, 55, 211, 22, 189], [1, 2, 3, 4, 5, 6]),
                  None)]
    elif name == "late_rows":
        state["next_emit"] = np.int32(150)       # min_frame 15 - 8 = 7
        calls = [(rows([35, 69, 70, 71, 99, 12], [0, 1, 2, 3, 4, 5],
                       [1, 1, 1, 1, 1, 0]), None)]
    elif name == "mixed_counts":
        calls = [(mixed(50_000, True), None)]
    elif name == "mixed_sums":
        calls = [(mixed(50_000, False), None)]
        exact = False
    elif name in ("bfloat16", "float16"):
        calls = [(mixed(20_000, False, getattr(torch, name)), None)]
        exact = False
    elif name == "hint_int":
        calls = [(rows([25, 31], [1, 2]), 1234)]
    elif name == "hint_tensor":
        calls = [(rows([25, 31], [1, 2]),
                  torch.tensor(1234, dtype=torch.int32, device=device))]
    elif name == "hint_below_frontier":
        calls = [(rows([25, 310], [1, 2]), 7)]
    elif name == "no_frontier_wm_lag":
        calls = [(rows([25, 310, 47], [1, 2, 3]), 200)]
    elif name == "two_calls":
        calls = [(mixed(5_000, True), None), (mixed(5_000, True), 33)]
    elif name == "empty_no_frontier":
        spec = VectorWindowSpec(size_ms=80, slide_ms=10, n_key_buckets=512,
                                ring_margin=8, frontier_from_data=False)
        calls = [(rows([], []), 90)]
    state = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in state.items()}
    return spec, state, calls, exact


ACC_CASES = ["q5_step", "q5_step_prices", "two_frames_one_slot", "conflicts",
             "late_rows", "mixed_counts", "mixed_sums", "bfloat16", "float16",
             "hint_int", "hint_tensor", "hint_below_frontier",
             "no_frontier_wm_lag", "two_calls", "empty_no_frontier"]


@pytest.mark.parametrize("name", ACC_CASES)
def test_accumulate_kernel_matches_plain(cuda, name):
    """One launch a call (none for no rows), and the whole state equal to
    the plain version's run on the card from the same state."""
    spec, state, calls, exact = _acc_case(name, cuda)
    want = {k: v.clone() for k, v in state.items()}
    for (ts, key, value, valid), hint in calls:
        before = accumulate_.launches
        accumulate_(state, ts, key, value, valid, wm_hint=hint,
                    **_acc_kw(spec))
        torch.cuda.synchronize()
        assert accumulate_.launches == before + (1 if ts.numel() else 0)
        accumulate_plain_(want, ts, key, value, valid, wm_hint=hint,
                          **_acc_kw(spec))
        for k in want:
            if k == "panes" and not exact:
                torch.testing.assert_close(state[k], want[k], **F32_TOL)
            else:
                assert torch.equal(state[k], want[k]), (name, k)
    if name == "mixed_counts":        # the case drops what it should
        assert int(state["dropped_late"]) > 2
        assert int(state["dropped_conflict"]) > 0


def test_accumulate_kernel_resets_its_workspace(cuda):
    """Back-to-back calls, and a call on another stream: the ticket, the ts
    maximum and the slot maxima carry nothing from one call to the next."""
    spec, state, calls, _ = _acc_case("two_calls", cuda)
    want = {k: v.clone() for k, v in state.items()}
    side = torch.cuda.Stream()
    for i in range(6):
        (ts, key, value, valid), hint = calls[i % 2]
        stream = side if i == 3 else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            accumulate_(state, ts, key, value, valid, wm_hint=hint,
                        **_acc_kw(spec))
        torch.cuda.current_stream().wait_stream(stream)
        accumulate_plain_(want, ts, key, value, valid, wm_hint=hint,
                          **_acc_kw(spec))
        torch.cuda.synchronize()
        for k in want:
            assert torch.equal(state[k], want[k]), (i, k)


def test_accumulate_kernel_rejects_what_it_cannot_read(cuda):
    spec, state, calls, _ = _acc_case("two_frames_one_slot", cuda)
    (ts, key, value, valid), _ = calls[0]
    before = accumulate_.launches
    with pytest.raises(TypeError, match="int32"):
        accumulate_(state, ts.long(), key, value, valid, **_acc_kw(spec))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        accumulate_(state, ts, key, value.double(), valid, **_acc_kw(spec))
    with pytest.raises(ValueError, match="the state on"):
        accumulate_(state, ts.cpu(), key, value, valid, **_acc_kw(spec))
    with pytest.raises(ValueError, match="no rows"):
        accumulate_(state, ts[:0], key[:0], value[:0], valid[:0],
                    **_acc_kw(spec))
    assert accumulate_.launches == before


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


# -- the engine path: q5(placement="device") through the host engine ---------

def _engine_q5(device, placement, n_nodes=1, kill_at_result=None):
    """tests/test_device_window.py's _run_q5 stream through the port's
    JetCluster: the sorted result set and the device processors."""
    from repro_torch.core import (CollectorSink, DeviceWindowProcessor,
                                  GUARANTEE_EXACTLY_ONCE, GUARANTEE_NONE,
                                  JetCluster, JobConfig,
                                  PacedGeneratorSource, VirtualClock)
    from repro_torch.core.engine import JOB_COMPLETED
    from repro_torch.nexmark import queries
    gen = NexmarkGenerator(rate=60_000, n_keys=40)
    cluster = JetCluster(n_nodes=n_nodes, cooperative_threads=2,
                         clock=VirtualClock(auto_step=0.001))
    out = []
    p = queries.q5(
        lambda: PacedGeneratorSource(gen, rate=60_000, max_events=12_000),
        lambda: CollectorSink(out), window_ms=100, slide_ms=20,
        placement=placement,
        device=dict(n_key_buckets=64, batch_size=256, device=device))
    job = cluster.submit(p.to_dag(), JobConfig(
        processing_guarantee=GUARANTEE_NONE if kill_at_result is None
        else GUARANTEE_EXACTLY_ONCE, snapshot_interval_s=0.02))
    killed = False
    while job.status != JOB_COMPLETED:
        cluster.step()
        if (kill_at_result is not None and not killed
                and len(out) >= kill_at_result and job.snapshots_taken > 0):
            cluster.kill_node(cluster.node_ids[-1])
            killed = True
    assert killed == (kill_at_result is not None)
    procs = [t.processor for t in job.execution.tasklets
             if isinstance(t.processor, DeviceWindowProcessor)]
    return sorted(set((ev.ts, ev.key, ev.value.window_end, ev.value.value)
                      for ev in out)), procs


def test_engine_q5_device_on_card_equals_host(cuda):
    """Device placement on the card gives host placement's results, one
    accumulate launch a device step (the warm-up step included), and
    nothing falls back to the CPU."""
    host, _ = _engine_q5(cuda, "host")
    before = accumulate_.launches
    got, procs = _engine_q5(cuda, "device")
    assert got == host and len(got) > 0
    assert procs and all(p.executor.device.type == "cuda" for p in procs)
    assert all(p.state["panes"].is_cuda for p in procs)
    steps = sum(p._steps for p in procs) + len(procs)
    assert accumulate_.launches - before == steps
    assert sum(p.late_dropped + p.conflict_dropped for p in procs) == 0


def test_engine_q5_restores_on_card_through_kill_node(cuda):
    """Exactly-once through a node kill: the restore builds the window
    state on the card (finish_snapshot_restore), and the output equals
    the run without a failure."""
    base, _ = _engine_q5(cuda, "device", n_nodes=2)
    got, procs = _engine_q5(cuda, "device", n_nodes=2, kill_at_result=30)
    assert got == base and len(base) > 0
    assert procs and all(p.state["panes"].is_cuda for p in procs)


def test_device_window_restore_on_card_equals_cpu(cuda):
    """The same snapshot entries restored on the card and on the CPU give
    the same state (ints and counts exactly), on the card's tensors, and
    the same results after."""
    from repro_torch.core import DeviceWindowProcessor, EventBlock, Watermark
    from repro_torch.core.processor import Inbox, Outbox, ProcessorContext
    from repro_torch.core.window import SlidingWindowDef, counting

    def make(device, index=0):
        proc = DeviceWindowProcessor(
            SlidingWindowDef(100, 20), counting(), n_key_buckets=16,
            batch_size=32, max_windows_per_step=4, ring_margin=2,
            device=device)
        box = Outbox(batch_limit=1_000_000)
        proc.init(box, ProcessorContext("q5.device", index, index, 1, 0, 1,
                                        ()))
        return proc, box

    def feed(proc, ts, keys):
        inbox = Inbox()
        inbox.add(EventBlock(np.asarray(ts, np.int64),
                             np.asarray(keys, np.int64)))
        proc.process(0, inbox)

    rng = np.random.RandomState(7)
    src, box = make(cuda)
    feed(src, np.sort(rng.randint(0, 200, 150)), rng.randint(0, 40, 150))
    while not src.try_process_watermark(Watermark(150)):
        pass
    feed(src, np.sort(rng.randint(160, 300, 40)), rng.randint(0, 40, 40))
    assert src.save_to_snapshot()
    entries = list(box.snapshot_queue)
    states, results = {}, {}
    for device in (cuda, torch.device("cpu")):
        proc, out = make(device, index=1)
        proc.restore_from_snapshot(entries)
        proc.finish_snapshot_restore()
        assert all(v.device.type == device.type for v in proc.state.values())
        # copies: the steps below update the state in place
        states[device.type] = {k: v.cpu().clone().numpy()
                               for k, v in proc.state.items()}
        while not proc.try_process_watermark(Watermark(400)):
            pass
        assert proc.complete()
        results[device.type] = [(ev.ts, ev.key, ev.value.value)
                                for ev in out.drain()]
    for k, v in states["cpu"].items():
        np.testing.assert_array_equal(states["cuda"][k], v, err_msg=k)
    assert states["cuda"]["panes"].any()
    assert results["cuda"] == results["cpu"] and results["cpu"]


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
    # rows around a tile and a cluster's first wave of tiles
    (1, 4, 8, 8, False, None),
    (1023, 2, 64, 600, False, None),
    (1024, 2, 64, 600, True, None),
    (1025, 2, 64, 600, False, 1),
    (8 * 1024 + 1, 4, 100, 3000, True, None),
    (2**20, 8, 512, 2**15, False, None),    # 16 tiles a block
    (2**20, 4, 4096, 2**16, False, 3),      # and overflow past C
    # C = 1: every row of a destination after its first overflows
    (3000, 4, 8, 1, True, None),
    (3000, 32, 2, 1, False, 31),
])
def test_route_pack_kernel_matches_plain(cuda, n_rows, n, k_loc, cap, oob,
                                         skew):
    """One launch of route_pack's cluster kernel and nothing else."""
    args = _pack_args(n_rows, n, k_loc, n_rows + n, cuda, oob, skew)
    before = (route_counts.launches, route_offsets.launches,
              route_pack.launches)
    got = route_pack(*args, n, k_loc, cap)
    torch.cuda.synchronize()
    assert (route_counts.launches, route_offsets.launches,
            route_pack.launches) == (before[0], before[1],
                                     before[2] + (1 if n_rows else 0))
    want = route_pack_plain(*args, n, k_loc, cap)
    assert torch.equal(got.send, want.send)
    assert torch.equal(got.pos, want.pos)
    assert int(got.n_overflow) == int(want.n_overflow)
    # as the route plan calls it: the same send, no positions stored
    bare = route_pack(*args, n, k_loc, cap, with_pos=False)
    assert bare.pos is None and torch.equal(bare.send, want.send)
    assert int(bare.n_overflow) == int(want.n_overflow)
    if skew == n - 1 or cap == 1:
        assert int(want.n_overflow) > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_route_pack_kernel_half_values(cuda, dtype):
    """bf16 and f16 values go out as their float32 bits."""
    args = _pack_args(5000, 4, 64, 9, cuda)
    args[2] = args[2].to(dtype)
    got = route_pack(*args, 4, 64, 2000)
    want = route_pack_plain(*args, 4, 64, 2000)
    assert torch.equal(got.send, want.send)
    assert torch.equal(got.pos, want.pos)


def test_route_pack_writes_every_cell(cuda):
    """send, pos and n_overflow come from torch.empty: a buffer whose
    memory held a non-zero pattern before the call must come out equal to
    the plain version, every cell written by the kernel."""
    args = _pack_args(16384, 4, 4096, 7, cuda, skew=2)
    want = route_pack_plain(*args, 4, 4096, 8192)
    for _ in range(3):
        torch.full((4, 4, 8192), -7, dtype=torch.int32, device=cuda)
        torch.full((16384,), 123, dtype=torch.int32, device=cuda)
        torch.full((), 99, dtype=torch.int32, device=cuda)
        got = route_pack(*args, 4, 4096, 8192)
        torch.cuda.synchronize()
        assert torch.equal(got.send, want.send)
        assert torch.equal(got.pos, want.pos)
        assert int(got.n_overflow) == int(want.n_overflow)


def test_route_pack_cluster_fits_the_card(cuda):
    """The cluster of the path's plan (8 blocks of 1024 threads, 16 KB of
    claims each) and of the largest plan fit on the card at least once."""
    for n_dest, cap in ((4, 8192), (32, 12288)):
        plan = pack_plan(16384, n_dest, cap)
        blocks, threads, clusters = pack_cluster(plan.cells_per_block,
                                                 cuda.index or 0)
        assert (blocks, threads) == (plan.blocks, 1024)
        assert clusters >= 1
    with pytest.raises(ValueError, match="cluster's shared memory"):
        route_pack(*_pack_args(100, 32, 2, 0, cuda), 32, 2, 12289)


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
