"""The port's device tier against the JAX package's, step by step.

Every scenario feeds the same numpy batches to ``repro.streaming``'s
``StreamExecutor`` and to ``repro_torch.streaming``'s (on the CPU, so its
kernels run their plain versions) and compares, after EVERY step, the
whole state dict and the step's outputs.  Counts, window ends, frame ids,
the emission front, the watermark and both drop counters must match
exactly; float sums of random values within ``rtol=1e-6, atol=1e-5``
(the two packages sum panes and windows in different orders).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import streaming as jst  # noqa: E402
from repro.nexmark import (  # noqa: E402
    DisorderedNexmarkGenerator as JaxDisordered,
    NexmarkGenerator as JaxGenerator)
from repro_torch import streaming as tst  # noqa: E402
from repro_torch.nexmark import (  # noqa: E402
    DisorderedNexmarkGenerator, NexmarkGenerator)
from repro_torch.streaming.state import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from repro.streaming.window import accumulate as jax_accumulate  # noqa: E402
from repro_torch.streaming.window import (  # noqa: E402
    accumulate, ieee_fp32_matmul)

F32_TOL = dict(rtol=1e-6, atol=1e-5)
OUT_KEYS = ("results", "window_ends", "valid")


@functools.cache
def _jax_executor(cfg):
    """One compiled JAX executor per configuration for the whole module:
    its step is pure, so tests can share it and skip recompiling."""
    return jst.StreamExecutor(cfg)


def _executors(B, snapshot_every=0, **spec_kw):
    jex = _jax_executor(jst.StreamJobConfig(
        window=jst.VectorWindowSpec(**spec_kw), batch_size=B,
        snapshot_every=snapshot_every))
    tex = tst.StreamExecutor(tst.StreamJobConfig(
        window=tst.VectorWindowSpec(**spec_kw), batch_size=B,
        snapshot_every=snapshot_every), device="cpu")
    return jex, tex


def _assert_state_equal(jstate, tstate, exact_panes):
    assert set(jstate) == set(tstate)
    for k in jstate:
        want = np.asarray(jstate[k])
        got = tstate[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "panes" and not exact_panes:
            np.testing.assert_allclose(got, want, **F32_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def _assert_out_equal(jout, tout, exact):
    for k in OUT_KEYS:
        want = np.asarray(jout[k])
        got = tout[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "results" and not exact:
            np.testing.assert_allclose(got, want, **F32_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    valid = np.asarray(jout["valid"])
    assert tout["rows"] == int(valid.sum())
    assert valid[:tout["rows"]].all()          # valid rows are a prefix


def _lockstep(jex, tex, batches, exact, jstate=None, tstate=None):
    """Step both executors through ``batches`` (numpy dicts), comparing the
    whole state and the outputs after every step."""
    jstate = jex.init_state() if jstate is None else jstate
    tstate = tex.init_state() if tstate is None else tstate
    got = {}
    for b in batches:
        jstate, jout = jex.step(jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        staged, count = tex.stage_batch(b)
        tstate, tout = tex.step(tstate, staged, valid_count=count)
        _assert_state_equal(jstate, tstate, exact)
        _assert_out_equal(jout, tout, exact)
        res, ends = tout["results"].numpy(), tout["window_ends"].numpy()
        for i in range(tout["rows"]):
            for k in np.nonzero(res[i])[0]:
                w = (int(ends[i]), int(k))
                got[w] = got.get(w, 0) + float(res[i][k])
    return jstate, tstate, got


def _oracle(ts, keys, vals, size, slide):
    """(window_end, key) -> sum over every window each event falls in."""
    out = {}
    for t, k, v in zip(ts.tolist(), keys.tolist(), vals.tolist()):
        f = t // slide
        for L in range(f, f + size // slide):
            out[((L + 1) * slide, k)] = out.get(((L + 1) * slide, k), 0) + v
    return out


def _values(n, valued, seed=99):
    if valued:
        return np.random.RandomState(seed).randn(n).astype(np.float32)
    return np.ones(n, np.float32)


def _batches(ts, keys, vals, B, flush_ts, n_flush):
    """test_streaming_device.py's batches_from + collect's flush steps."""
    n = len(ts)
    for i in range(0, n, B):
        sl = slice(i, i + B)
        m = len(ts[sl])
        pad = B - m
        yield {"ts": np.pad(ts[sl], (0, pad)),
               "key": np.pad(keys[sl], (0, pad)),
               "value": np.pad(vals[sl], (0, pad)),
               "valid": np.pad(np.ones(m, bool), (0, pad)),
               "wm": np.asarray(-1, np.int32)}
    for _ in range(n_flush):
        yield {"ts": np.zeros(B, np.int32), "key": np.zeros(B, np.int32),
               "value": np.zeros(B, np.float32), "valid": np.zeros(B, bool),
               "wm": np.asarray(flush_ts, np.int32)}


def _make_events(n, n_keys, valued):
    rng = np.random.RandomState(0)
    ts = np.sort(rng.randint(0, 500, size=n)).astype(np.int32)
    keys = rng.randint(0, n_keys, size=n).astype(np.int32)
    return ts, keys, _values(n, valued)


VALUED = pytest.mark.parametrize("valued", [False, True],
                                 ids=["count", "sum"])


@VALUED
def test_vector_window_matches_jax_single_device(valued):
    """test_streaming_device.py::test_vector_window_matches_oracle_single_device"""
    ts, keys, vals = _make_events(600, 64, valued)
    jex, tex = _executors(32, size_ms=60, slide_ms=10, n_key_buckets=64,
                          max_windows_per_step=8, ring_margin=10)
    _, tstate, got = _lockstep(
        jex, tex, _batches(ts, keys, vals, 32, 2000, 64), exact=not valued)
    assert int(tstate["dropped_conflict"]) == 0
    if not valued:
        assert got == _oracle(ts, keys, vals, 60, 10)


@VALUED
def test_vector_window_drops_match_jax(valued):
    """test_streaming_device.py::test_vector_window_counts_drops_no_silent_loss"""
    ts, keys, vals = _make_events(400, 16, valued)
    jex, tex = _executors(64, size_ms=40, slide_ms=10, n_key_buckets=16,
                          max_windows_per_step=2, ring_margin=1)
    _lockstep(jex, tex, _batches(ts, keys, vals, 64, 3000, 64),
              exact=not valued)


def _disorder_inputs(valued, disordered=True):
    rng = np.random.RandomState(1)
    n, skew = 800, 50
    ts = np.sort(rng.randint(0, 600, n)).astype(np.int32)
    keys = rng.randint(0, 32, n).astype(np.int32)
    order = np.argsort(ts + rng.randint(0, skew, n), kind="stable")
    if not disordered:
        order = np.arange(n)
    return ts[order], keys[order], _values(n, valued)[order], skew


@VALUED
def test_device_wm_lag_disorder_matches_jax(valued):
    """test_device_window.py::test_device_wm_lag_disorder_equivalence"""
    runs = []
    for disordered in (False, True):
        ts, keys, vals, skew = _disorder_inputs(valued, disordered)
        jex, tex = _executors(64, size_ms=100, slide_ms=10, n_key_buckets=32,
                              max_windows_per_step=4, ring_margin=8,
                              wm_lag=skew)
        _, tstate, got = _lockstep(jex, tex,
                                   _batches(ts, keys, vals, 64, 4000, 8),
                                   exact=not valued)
        assert int(tstate["dropped_late"]) == 0
        runs.append(got)
    if not valued:
        assert runs[0] == runs[1] == _oracle(ts, keys, vals, 100, 10)


@VALUED
def test_device_without_wm_lag_drops_match_jax(valued):
    """test_device_window.py::test_device_without_wm_lag_drops_disordered"""
    ts, keys, vals, _ = _disorder_inputs(valued)
    jex, tex = _executors(64, size_ms=100, slide_ms=10, n_key_buckets=32,
                          max_windows_per_step=4, ring_margin=8)
    _, tstate, got = _lockstep(jex, tex,
                               _batches(ts, keys, vals, 64, 4000, 8),
                               exact=not valued)
    if not valued:
        assert (int(tstate["dropped_late"]) > 0
                or got != _oracle(ts, keys, vals, 100, 10))


def _one_key_batch(ts_list, B=32, wm=-1, valued=False):
    m = len(ts_list)
    pad = B - m
    return {"ts": np.pad(np.asarray(ts_list, np.int32), (0, pad)),
            "key": np.zeros(B, np.int32),
            "value": np.pad(_values(m, valued, seed=m), (0, pad)),
            "valid": np.pad(np.ones(m, bool), (0, pad)),
            "wm": np.asarray(wm, np.int32)}


@VALUED
def test_emit_catches_up_after_idle_then_burst_matches_jax(valued):
    """test_device_window.py::test_emit_catches_up_after_idle_then_burst"""
    jex, tex = _executors(32, size_ms=40, slide_ms=10, n_key_buckets=16,
                          max_windows_per_step=2, ring_margin=2)
    batches = [_one_key_batch([5, 7, 12], valued=valued),
               _one_key_batch([], wm=100_000),
               _one_key_batch([100_005, 100_013, 100_017], valued=valued),
               _one_key_batch([], wm=100_100)]
    _, tstate, got = _lockstep(jex, tex, batches, exact=not valued)
    assert int(tstate["next_emit"]) > 100_000
    assert int(tstate["dropped_conflict"]) == 0
    if not valued:
        ts = np.asarray([5, 7, 12, 100_005, 100_013, 100_017])
        assert got == _oracle(ts, np.zeros(6, np.int64), np.ones(6), 40, 10)


@VALUED
def test_emit_output_buffer_bounded_matches_jax(valued):
    """test_device_window.py::test_emit_output_buffer_bounded_but_progressing"""
    jex, tex = _executors(32, size_ms=40, slide_ms=10, n_key_buckets=16,
                          max_windows_per_step=1, ring_margin=20,
                          emit_rounds=2)
    batches = [_one_key_batch(list(range(0, 200, 10)), valued=valued)]
    batches += [_one_key_batch([], wm=1000) for _ in range(40)]
    _, _, got = _lockstep(jex, tex, batches, exact=not valued)
    if not valued:
        ts = np.arange(0, 200, 10)
        assert got == _oracle(ts, np.zeros(20, np.int64), np.ones(20), 40, 10)
    assert tex.emit_rounds > 0
    assert tex.host_syncs >= tex.emit_rounds + len(batches)


def test_spec_derived_sizes_match_jax():
    for kw in (dict(size_ms=10_000, slide_ms=10, n_key_buckets=16384,
                    max_windows_per_step=8, ring_margin=8),
               dict(size_ms=100, slide_ms=10, wm_lag=55),
               dict(size_ms=40, slide_ms=10, emit_rounds=2)):
        j, t = jst.VectorWindowSpec(**kw), tst.VectorWindowSpec(**kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for prop in ("frames_per_window", "ring_len", "emit_rounds_resolved",
                     "emit_buffer_rows"):
            assert getattr(j, prop) == getattr(t, prop), prop


# ---------------------------------------------------------------------------
# The slice end to end: NEXMark Q5 through run_stream
# ---------------------------------------------------------------------------

Q5 = dict(size_ms=1000, slide_ms=10, n_key_buckets=128,
          max_windows_per_step=4, ring_margin=8)
Q5_B = 256
Q5_RATE = 25_600          # 256 seqs per step = 10 ms of event time


def _q5_gen(gen, K=128):
    def event_gen(start, B):
        blk = gen.gen_block(np.arange(start, start + B))
        return {"ts": blk.ts.astype(np.int32),
                "key": (blk.key % K).astype(np.int32),
                "value": np.ones(B, np.float32),
                "valid": blk.cols["kind"] == 2}       # bids only
    return event_gen


def test_q5_run_stream_matches_jax():
    n_steps = 300
    jex, tex = _executors(Q5_B, snapshot_every=64, **Q5)
    jstate, jres = jex.run_stream(_q5_gen(JaxGenerator(rate=Q5_RATE)),
                                  n_steps)
    tstate, tres = tex.run_stream(_q5_gen(NexmarkGenerator(rate=Q5_RATE)),
                                  n_steps)
    _assert_state_equal(jstate, tstate, exact_panes=True)
    assert len(tres) == len(jres) > 0
    for (je, jr), (te, tr) in zip(jres, tres):
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tr, jr)
    assert int(tstate["dropped_late"]) == 0
    assert int(tstate["dropped_conflict"]) == 0
    # snapshot_every: the last backup (step 256) equals the JAX package's
    _assert_state_equal(jex._last_backup, tex._last_backup, exact_panes=True)
    assert not torch.equal(tex._last_backup["panes"], tstate["panes"])


def test_q5_snapshot_restore_continues_like_jax():
    """A snapshot is a copy (not an alias of the in-place state); running
    on after restore gives the same steps as the JAX package's."""
    gen = _q5_gen(NexmarkGenerator(rate=Q5_RATE))
    batches = [gen(i * Q5_B, Q5_B) for i in range(220)]
    jex, tex = _executors(Q5_B, **Q5)
    jstate, tstate, _ = _lockstep(jex, tex, batches[:150], exact=True)
    jbackup = jex.snapshot(jstate)
    backup = tex.snapshot(tstate)
    frozen = state_to_numpy(backup)
    # run on from the live state: the backup must not move
    _lockstep(jex, tex, batches[150:], exact=True, jstate=jstate,
              tstate=tstate)
    for k, v in state_to_numpy(backup).items():
        np.testing.assert_array_equal(v, frozen[k], err_msg=k)
    # restore and replay the same stretch: lockstep with JAX's restore
    _lockstep(jex, tex, batches[150:], exact=True,
              jstate=jex.restore(jbackup), tstate=tex.restore(backup))
    for k, v in state_to_numpy(backup).items():
        np.testing.assert_array_equal(v, frozen[k], err_msg=k)


def test_q5_jax_state_continues_in_port():
    """A JAX run stopped mid-stream continues in the port through
    state_from_numpy and ends in the JAX run's own final state."""
    gen = _q5_gen(NexmarkGenerator(rate=Q5_RATE))
    batches = [gen(i * Q5_B, Q5_B) for i in range(240)]
    jex, tex = _executors(Q5_B, **Q5)
    jstate = jex.init_state()
    for b in batches[:130]:
        jstate, _ = jex.step(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
    np_state = {k: np.asarray(v) for k, v in jstate.items()}
    tstate = state_from_numpy(np_state, device="cpu")
    for k, v in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(v, np_state[k], err_msg=k)
        assert v.dtype == np_state[k].dtype
    _lockstep(jex, tex, batches[130:], exact=True, jstate=jstate,
              tstate=tstate)


def test_state_from_numpy_rejects_wrong_dtypes():
    spec = tst.VectorWindowSpec(size_ms=40, slide_ms=10, n_key_buckets=8)
    good = state_to_numpy(tst.window_state_init(spec, device="cpu"))
    state_from_numpy(good, device="cpu")
    for k, bad in (("panes", good["panes"].astype(np.float64)),
                   ("slot_frame", good["slot_frame"].astype(np.int64)),
                   ("watermark", np.asarray(-1, np.int64))):
        with pytest.raises(ValueError):
            state_from_numpy(dict(good, **{k: bad}), device="cpu")


@pytest.mark.parametrize("disordered", [False, True])
def test_generator_copy_matches_jax(disordered):
    gen, jgen = NexmarkGenerator(rate=50_000), JaxGenerator(rate=50_000)
    if disordered:
        gen = DisorderedNexmarkGenerator(gen, max_skew_ms=20, seed=3)
        jgen = JaxDisordered(jgen, max_skew_ms=20, seed=3)
    seqs = np.concatenate([np.arange(5000),
                           np.random.RandomState(2).randint(0, 10**9, 500)])
    blk, jblk = gen.gen_block(seqs), jgen.gen_block(seqs)
    for col in ("ts", "key", "value"):
        np.testing.assert_array_equal(getattr(blk, col), getattr(jblk, col))
    assert blk.cols.keys() == jblk.cols.keys()
    for col in blk.cols:
        np.testing.assert_array_equal(blk.cols[col], jblk.cols[col])
    for seq in (0, 3, 4, 49, 777):
        (t, k, v), (jt, jk, jv) = gen(seq), jgen(seq)
        assert (t, k, type(v).__name__) == (jt, jk, type(jv).__name__)
        assert [getattr(v, a) for a in v.__slots__] == \
            [getattr(jv, a) for a in jv.__slots__]


# ---------------------------------------------------------------------------
# Entry points run on the card unless told otherwise; no hidden fallback
# ---------------------------------------------------------------------------


def test_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tst.StreamJobConfig(window=tst.VectorWindowSpec(size_ms=40,
                                                          slide_ms=10))
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.StreamExecutor(cfg)
    tst.StreamExecutor(cfg, device="cpu")      # asked for: runs


def test_unported_paths_raise():
    cfg = tst.StreamJobConfig(window=tst.VectorWindowSpec(size_ms=40,
                                                          slide_ms=10))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.StreamExecutor(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tst.StreamExecutor(dataclasses.replace(cfg, exchange="route"),
                           device="cpu")


def test_step_rejects_batch_on_other_device():
    cfg = tst.StreamJobConfig(window=tst.VectorWindowSpec(size_ms=40,
                                                          slide_ms=10),
                              batch_size=4)
    ex = tst.StreamExecutor(cfg, device="cpu")
    batch = {k: torch.zeros(4, dtype=d, device="meta") for k, d in
             (("ts", torch.int32), ("key", torch.int32),
              ("value", torch.float32), ("valid", torch.bool))}
    with pytest.raises(ValueError, match="stage"):
        ex.step(ex.init_state(), batch)


def test_stage_batch_canonicalises_dtypes_like_jax():
    cfg = tst.StreamJobConfig(window=tst.VectorWindowSpec(size_ms=40,
                                                          slide_ms=10),
                              batch_size=4)
    ex = tst.StreamExecutor(cfg, device="cpu")
    staged, count = ex.stage_batch({
        "ts": np.arange(4, dtype=np.int64), "key": np.arange(4),
        "value": np.ones(4), "valid": np.array([1, 0, 1, 1], bool),
        "wm": np.asarray(-1), "extra": None})
    assert count == 3 and staged["extra"] is None
    assert staged["ts"].dtype == staged["key"].dtype == torch.int32
    assert staged["value"].dtype == torch.float32
    assert staged["wm"].dtype == torch.int32 and staged["wm"].dim() == 0


def test_ieee_fp32_matmul_pins_and_restores():
    matmul = torch.backends.cuda.matmul
    prev = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        with ieee_fp32_matmul():
            assert matmul.fp32_precision == "ieee"
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = prev


def test_out_of_range_key_bucket_contributes_nothing():
    """A valid event with a key outside [0, K) adds nothing in the port, as
    in the reference's kernel; the reference's accumulate instead lands it
    in a neighbouring slot's pane (ROADMAP.md §3 logs the difference)."""
    kw = dict(size_ms=40, slide_ms=10, n_key_buckets=16)
    arrays = (np.array([25, 25], np.int32), np.array([17, 3], np.int32),
              np.ones(2, np.float32), np.ones(2, bool))
    jstate = jst.window_state_init(jst.VectorWindowSpec(**kw))
    jpanes = np.asarray(jax_accumulate(jst.VectorWindowSpec(**kw), jstate, *(
        jnp.asarray(a) for a in arrays))["panes"])
    spec = tst.VectorWindowSpec(**kw)
    panes = accumulate(spec, tst.window_state_init(spec, device="cpu"), *(
        torch.from_numpy(a) for a in arrays))["panes"].numpy()
    # frame 2 lives in slot 2; key 3 is counted by both packages
    assert panes[2, 3] == jpanes[2, 3] == 1
    assert panes.sum() == 1                      # key 17 dropped
    assert jpanes[3, 1] == 1                     # 2 * 16 + 17 = slot 3, key 1
