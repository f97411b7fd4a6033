"""The port's stage-1 ``accumulate`` against the JAX package's
(``repro/streaming/window.py::accumulate``), one call or two at a time,
the WHOLE state compared after each call.

Both sides get the same numpy inputs (``RandomState(seed)``).  The port
runs on CPU tensors, i.e. ``accumulate_plain_`` (the Hopper kernel is held
against that plain version on the card, in ``test_torch_cuda.py`` and
``chip_smoke.py``).  Frames, counters, the watermark and the emission
front must match exactly, panes exactly where the values are counts, and
within ``rtol=1e-6, atol=1e-5`` where they are random float sums (the two
packages add in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.streaming.window import (  # noqa: E402
    VectorWindowSpec as JaxSpec, accumulate as jax_accumulate)
from repro_torch.kernels.window_agg import (  # noqa: E402
    accumulate_, accumulate_plain_)
from repro_torch.streaming.window import (  # noqa: E402
    VectorWindowSpec, accumulate)

F32_TOL = dict(rtol=1e-6, atol=1e-5)
# R = 4 frames a window + 4 of margin = 8 slots of 16 key buckets
BASE = dict(size_ms=40, slide_ms=10, n_key_buckets=16)


def _rows(ts, keys, valid=None, values=None):
    n = len(ts)
    return (np.asarray(ts, np.int32), np.asarray(keys, np.int32),
            np.ones(n, np.float32) if values is None
            else np.asarray(values, np.float32),
            np.ones(n, bool) if valid is None else np.asarray(valid, bool))


def _random_rows(rng, n, frames, keys=16, p_valid=0.9, counts=False):
    ts = rng.randint(frames[0] * 10, frames[1] * 10, n)
    return _rows(ts, rng.randint(0, keys, n), rng.rand(n) < p_valid,
                 None if counts else rng.randn(n))


# the cases whose spec differs from BASE (wm_lag 15 and 25 add 2 and 3
# slots to the ring)
SPECS = {"no_frontier_wm_lag": dict(frontier_from_data=False, wm_lag=15),
         "no_frontier_no_hint": dict(frontier_from_data=False),
         "wm_lag": dict(wm_lag=25),
         "empty_no_frontier": dict(frontier_from_data=False)}


def _case(name):
    """``(spec kwargs, initial state, [(rows, wm_hint), ...], value dtype,
    exact panes)`` of case ``name``; the state in numpy."""
    rng = np.random.RandomState(sum(map(ord, name)))
    spec = dict(BASE, **SPECS.get(name, {}))
    R, K = VectorWindowSpec(**spec).ring_len, 16
    state = {"panes": np.zeros((R, K), np.float32),
             "slot_frame": np.full(R, -1, np.int32),
             "watermark": np.int32(-1), "next_emit": np.int32(-1),
             "dropped_late": np.int32(0), "dropped_conflict": np.int32(0)}
    dtype, exact = "float32", True
    calls = None
    if name == "two_frames_one_slot":
        # frames 2 and 10 share slot 2, empty on entry: both go live
        calls = [(_rows([25, 105, 27, 103, 21], [1, 2, 1, 4, 9]), None)]
    elif name == "conflicts":
        # slot 2 holds frame 2, slot 5 frame 13: frames 10 and 5 conflict
        state["slot_frame"][[2, 5]] = [2, 13]
        state["next_emit"] = np.int32(30)
        calls = [(_rows([25, 105, 55, 131, 22, 109], [1, 2, 3, 4, 5, 6]),
                  None)]
    elif name == "late_rows":
        # next_emit 100: min_frame 100 // 10 - 4 = 6; frames 3 and 5 late
        state["next_emit"] = np.int32(100)
        state["watermark"] = np.int32(95)
        calls = [(_rows([35, 59, 60, 71, 99, 12], [0, 1, 2, 3, 4, 5],
                        valid=[1, 1, 1, 1, 1, 0]), None)]
    elif name == "keys_out_of_range":
        # keys -1, K, K + 17 and far outside, from slots 0, 3 and 7
        calls = [(_rows([5, 5, 5, 35, 35, 75, 75, 75, 5],
                        [-1, 16, 33, -1, 16, 16, 33, 200, -300]), None)]
    elif name == "random_state":
        state["panes"] = rng.randint(0, 5, (R, K)).astype(np.float32)
        state["slot_frame"][:] = [8, -1, 10, 11, -1, 13, -1, 15]
        state["next_emit"] = np.int32(120)
        state["watermark"] = np.int32(119)
        state["dropped_late"] = np.int32(3)
        state["dropped_conflict"] = np.int32(5)
        calls = [(_random_rows(rng, 300, (6, 20), keys=20, counts=True),
                  None)]
    elif name == "random_sums":
        calls = [(_random_rows(rng, 400, (0, 12)), None)]
        exact = False
    elif name == "hint_int":
        calls = [(_rows([25, 31], [1, 2]), 1234)]
    elif name == "hint_tensor":
        calls = [(_rows([25, 31], [1, 2]), "tensor:1234")]
    elif name == "hint_below_frontier":
        calls = [(_rows([25, 310], [1, 2]), 7)]
    elif name == "no_frontier_wm_lag":
        calls = [(_rows([25, 310, 47], [1, 2, 3]), 200)]
    elif name == "no_frontier_no_hint":
        calls = [(_rows([25, 31, 47], [1, 2, 3]), None)]
    elif name == "wm_lag":
        calls = [(_random_rows(rng, 200, (0, 9), counts=True), None)]
    elif name in ("bfloat16", "float16"):
        dtype = name
        exact = False
        calls = [(_random_rows(rng, 300, (0, 6)), None)]
    elif name == "two_calls":
        calls = [(_random_rows(rng, 200, (0, 4), counts=True), None),
                 (_random_rows(rng, 200, (3, 7), counts=True), 33)]
    elif name == "empty_no_frontier":
        state["watermark"] = np.int32(40)
        calls = [(_rows([], []), 90)]
    elif name == "negative_ts":
        calls = [(_rows([-5, -15, -25, 3], [1, 2, 3, 4]), None)]
    return spec, state, calls, dtype, exact


CASES = ["two_frames_one_slot", "conflicts", "late_rows", "keys_out_of_range",
         "random_state", "random_sums", "hint_int", "hint_tensor",
         "hint_below_frontier", "no_frontier_wm_lag", "no_frontier_no_hint",
         "wm_lag", "bfloat16", "float16", "two_calls", "empty_no_frontier",
         "negative_ts"]


# what a case must show, whichever side computes it: (state key, value)
SHOWS = {"two_frames_one_slot": ("dropped_conflict", 0),
         "conflicts": ("dropped_conflict", 3),
         "late_rows": ("dropped_late", 2),
         "hint_int": ("watermark", 1234),
         "hint_tensor": ("watermark", 1234),
         "hint_below_frontier": ("watermark", 310),
         "no_frontier_wm_lag": ("watermark", 200),
         "no_frontier_no_hint": ("watermark", -1),
         "empty_no_frontier": ("watermark", 90)}


def _hint(h, lib):
    if isinstance(h, str):
        v = int(h.split(":")[1])
        return torch.tensor(v, dtype=torch.int32) if lib == "torch" \
            else jnp.asarray(v, jnp.int32)
    return h


def _assert_state(got, want, exact):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "panes" and not exact:
            np.testing.assert_allclose(g, w, **F32_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_accumulate_plain_matches_jax(name):
    spec_kw, state, calls, dtype, exact = _case(name)
    spec, jspec = VectorWindowSpec(**spec_kw), JaxSpec(**spec_kw)
    assert state["panes"].shape == (spec.ring_len, spec.n_key_buckets)
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    for (ts, key, value, valid), hint in calls:
        jstate = jax_accumulate(jspec, jstate, jnp.asarray(ts),
                                jnp.asarray(key),
                                jnp.asarray(value).astype(getattr(jnp,
                                                                  dtype)),
                                jnp.asarray(valid), _hint(hint, "jax"))
        before = accumulate_.launches
        out = accumulate_plain_(
            tstate, torch.from_numpy(ts), torch.from_numpy(key),
            torch.from_numpy(value).to(getattr(torch, dtype)),
            torch.from_numpy(valid), slide_ms=spec.slide_ms,
            frames_per_window=spec.frames_per_window, wm_lag=spec.wm_lag,
            frontier_from_data=spec.frontier_from_data,
            wm_hint=_hint(hint, "torch"))
        assert out is tstate and accumulate_.launches == before
        _assert_state(tstate, jstate, exact)
    if name in SHOWS:
        key, value = SHOWS[name]
        assert int(tstate[key]) == value
    if name == "two_frames_one_slot":      # both frames added, 10 recorded
        assert tstate["panes"].sum() == 5 and tstate["slot_frame"][2] == 10


@pytest.mark.parametrize("name", ["two_frames_one_slot", "keys_out_of_range",
                                  "hint_tensor", "no_frontier_wm_lag"])
def test_accumulate_dispatches_to_plain_on_cpu(name):
    """``streaming.window.accumulate`` and ``accumulate_`` on CPU tensors
    are the plain version: the same state, no launch."""
    spec_kw, state, calls, dtype, _ = _case(name)
    spec = VectorWindowSpec(**spec_kw)
    states = [{k: torch.from_numpy(np.array(v)) for k, v in state.items()}
              for _ in range(3)]
    kw = dict(slide_ms=spec.slide_ms,
              frames_per_window=spec.frames_per_window, wm_lag=spec.wm_lag,
              frontier_from_data=spec.frontier_from_data)
    before = accumulate_.launches
    for (ts, key, value, valid), hint in calls:
        rows = [torch.from_numpy(a) for a in (ts, key, value, valid)]
        accumulate(spec, states[0], *rows, _hint(hint, "torch"))
        accumulate_(states[1], *rows, wm_hint=_hint(hint, "torch"), **kw)
        accumulate_plain_(states[2], *rows, wm_hint=_hint(hint, "torch"),
                          **kw)
    assert accumulate_.launches == before
    for k in state:
        assert torch.equal(states[0][k], states[2][k]), k
        assert torch.equal(states[1][k], states[2][k]), k


def test_accumulate_of_no_rows_needs_no_frontier():
    """A data-driven frontier over no rows is a max over nothing: the
    reference raises, and so does the port (on either device)."""
    spec = VectorWindowSpec(**BASE)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in _case("two_frames_one_slot")[1].items()}
    z = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="no rows"):
        accumulate(spec, state, z, z, torch.zeros(0),
                   torch.zeros(0, dtype=torch.bool))


def test_accumulate_rejects_panes_of_another_spec():
    spec = VectorWindowSpec(**BASE)
    other = VectorWindowSpec(**dict(BASE, n_key_buckets=32))
    state = {k: torch.from_numpy(np.array(v))
             for k, v in _case("two_frames_one_slot")[1].items()}
    rows = [torch.from_numpy(a) for a in _rows([5], [1])]
    with pytest.raises(ValueError, match="spec"):
        accumulate(other, state, *rows)
    accumulate(spec, state, *rows)
