"""The port's multi-device tier against the JAX package's, step by step.

One module fixture runs every scenario twice, at the same time, from the
same numpy inputs (``SCENARIO_CODE``, which both runs execute):

* the JAX package's ``StreamExecutor`` on 8 host devices
  (``--xla_force_host_platform_device_count=8``), in one subprocess;
* the port's on 8 gloo ranks on the CPU, spawned by
  ``repro_torch.launch.mesh.spawn_ranks`` from a second subprocess (a
  4-shard scenario runs on ranks 0-3).

Each run saves every step's outputs and state; the tests then compare,
after EVERY step, the port's shards put together with the JAX package's
whole arrays.  Counts, window ends, frame ids, the emission front, the
watermark and both drop counters match exactly; sums of random values
within ``rtol=1e-5`` (the two packages add panes, partial panes and
windows in different orders; the values are positive, so no sum cancels
towards zero).  A scenario that fails in either run fails every test of
that scenario, and only those: the port's run starts a fresh set of ranks
after the scenario that failed.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.streaming.state import gather_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SUM_TOL = dict(rtol=1e-5, atol=0)
TIMEOUT_S = 400

SCENARIO_CODE = textwrap.dedent('''
    import numpy as np


    def _wm(v):
        return np.asarray(v, np.int32)


    def _pad(ts, keys, vals, B, wm=-1):
        out = []
        for i in range(0, len(ts), B):
            m = len(ts[i:i + B])
            pad = B - m
            out.append({"ts": np.pad(ts[i:i + B], (0, pad)),
                        "key": np.pad(keys[i:i + B], (0, pad)),
                        "value": np.pad(vals[i:i + B], (0, pad)),
                        "valid": np.pad(np.ones(m, bool), (0, pad)),
                        "wm": _wm(wm)})
        return out


    def _flush(B, wm, count):
        return [{"ts": np.zeros(B, np.int32), "key": np.zeros(B, np.int32),
                 "value": np.zeros(B, np.float32),
                 "valid": np.zeros(B, bool), "wm": _wm(wm)}
                for _ in range(count)]


    def _spmd():
        """test_streaming_device.py's SPMD_SCRIPT workload."""
        rng = np.random.RandomState(0)
        n = 600
        ts = np.sort(rng.randint(0, 500, size=n)).astype(np.int32)
        keys = rng.randint(0, 64, size=n).astype(np.int32)
        return _pad(ts, keys, np.ones(n, np.float32), 32) + _flush(32, 2000,
                                                                   64)


    def _overflow():
        """B 256 on 4 shards: C = 32 cells a destination for 64 events a
        source; most keys go to one owner, every third step to the last
        shard (more than C from one source, then invalid rows after)."""
        rng = np.random.RandomState(1)
        B, out = 256, []
        for i in range(10):
            ts = (i * 10 + np.sort(rng.randint(0, 10, B))).astype(np.int32)
            hot = rng.randint(48, 64, B) if i % 3 == 2 else \\
                rng.randint(0, 16, B)
            keys = np.where(rng.rand(B) < 0.72, hot, rng.randint(0, 64, B))
            out.append({"ts": ts, "key": keys.astype(np.int32),
                        "value": np.ones(B, np.float32),
                        "valid": rng.rand(B) > 0.15, "wm": _wm(-1)})
        return out + _flush(B, 500, 6)


    #: K = 32 on 4 shards (K_loc 8): -1, K and K + K_loc, and beyond
    OOB_KEYS = [-1, 32, 40, -9, -100, 96]


    def _oob():
        rng = np.random.RandomState(2)
        B, out = 32, []
        for i in range(12):
            ts = (i * 10 + np.sort(rng.randint(0, 10, B))).astype(np.int32)
            keys = np.where(rng.rand(B) < 0.3, rng.choice(OOB_KEYS, B),
                            rng.randint(0, 32, B))
            out.append({"ts": ts, "key": keys.astype(np.int32),
                        "value": np.ones(B, np.float32),
                        "valid": rng.rand(B) > 0.1, "wm": _wm(-1)})
        return out + _flush(B, 1000, 6)


    def _lag():
        """Disorder up to 25 ms against a 20 ms wm_lag (some events come
        late); random positive values."""
        rng = np.random.RandomState(3)
        B, out = 32, []
        for i in range(16):
            ts = np.clip(i * 10 + rng.randint(0, 10, B)
                         - rng.randint(0, 26, B), 0, None).astype(np.int32)
            out.append({"ts": ts,
                        "key": rng.randint(0, 32, B).astype(np.int32),
                        "value": rng.uniform(0.5, 1.5, B).astype(np.float32),
                        "valid": rng.rand(B) > 0.1, "wm": _wm(-1)})
        return out + _flush(B, 1000, 6)


    def _hint():
        """The watermark from hints alone; an idle gap of 200 ms, then a
        burst; random positive values."""
        rng = np.random.RandomState(4)
        B, out = 32, []
        for i in range(14):
            t0 = i * 10 + (200 if i >= 8 else 0)
            out.append({"ts": (t0 + np.sort(rng.randint(0, 10, B))).astype(
                            np.int32),
                        "key": rng.randint(0, 32, B).astype(np.int32),
                        "value": rng.uniform(0.5, 1.5, B).astype(np.float32),
                        "valid": rng.rand(B) > 0.1, "wm": _wm(t0 - 15)})
        return out + _flush(B, 2000, 6)


    def _elastic():
        """test_elastic_streaming.py's batches."""
        rng = np.random.RandomState(0)
        B = 32
        out = []
        for i in range(12):
            ts = (i * 10 + np.sort(rng.randint(0, 10, B))).astype(np.int32)
            out.append({"ts": ts, "key": rng.randint(0, 64, B).astype(
                            np.int32),
                        "value": np.ones(B, np.float32),
                        "valid": np.ones(B, bool), "wm": _wm(-1)})
        return out


    SPMD_SPEC = dict(size_ms=60, slide_ms=10, n_key_buckets=64,
                     max_windows_per_step=8, ring_margin=10)
    SMALL = dict(size_ms=40, slide_ms=10, n_key_buckets=32,
                 max_windows_per_step=4, ring_margin=8)
    SCENARIOS = {
        "spmd_reduce": dict(ranks=8, exchange="reduce", spec=SPMD_SPEC, B=32,
                            batches=_spmd, exact=True, snapshot=10),
        "spmd_route": dict(ranks=8, exchange="route", spec=SPMD_SPEC, B=32,
                           batches=_spmd, exact=True, snapshot=10),
        "overflow_route": dict(ranks=4, exchange="route",
                               spec=dict(SMALL, n_key_buckets=64), B=256,
                               batches=_overflow, exact=True),
        "oob_reduce": dict(ranks=4, exchange="reduce", spec=SMALL, B=32,
                           batches=_oob, exact=True),
        "oob_route": dict(ranks=4, exchange="route", spec=SMALL, B=32,
                          batches=_oob, exact=True),
        "lag_reduce": dict(ranks=4, exchange="reduce",
                           spec=dict(SMALL, wm_lag=20, ring_margin=4), B=32,
                           batches=_lag, exact=False),
        "lag_route": dict(ranks=4, exchange="route",
                          spec=dict(SMALL, wm_lag=20, ring_margin=4), B=32,
                          batches=_lag, exact=False),
        "hint_route": dict(ranks=4, exchange="route",
                           spec=dict(SMALL, frontier_from_data=False,
                                     max_windows_per_step=2, emit_rounds=2),
                           B=32, batches=_hint, exact=False),
        "migrate_4_8": dict(ranks=(4, 8), exchange="reduce", spec=SPMD_SPEC,
                            B=32, batches=_elastic, exact=True, split=6),
        "migrate_8_4": dict(ranks=(8, 4), exchange="reduce", spec=SPMD_SPEC,
                            B=32, batches=_elastic, exact=True, split=6),
        # the JAX package's spmd_reduce state after 10 steps, continued in
        # the port from step 10 (held against the JAX run's later steps)
        "jax_state": dict(ranks=8, exchange="reduce", spec=SPMD_SPEC, B=32,
                          batches=_spmd, exact=True, start=10,
                          source="spmd_reduce"),
    }
    STATE_KEYS = ("panes", "slot_frame", "watermark", "next_emit",
                  "dropped_late", "dropped_conflict")
    OUT_KEYS = ("results", "window_ends", "valid")


    def save(path, rec):
        """np.savez to path, atomically (a reader never sees half)."""
        tmp = path + ".tmp.npz"
        np.savez(tmp, **rec)
        os.replace(tmp, path)
''')

JAX_SCRIPT = textwrap.dedent('''
    import os
    import sys
    import traceback
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax.numpy as jnp
    from repro.launch.mesh import make_smoke_mesh
    from repro.streaming import (StreamExecutor, StreamJobConfig,
                                 VectorWindowSpec)
''') + SCENARIO_CODE + textwrap.dedent('''
    OUT = sys.argv[1]
    MESHES = {n: make_smoke_mesh((n,), ("data",)) for n in (4, 8)}


    def run_steps(ex, state, batches, first, rec):
        for s, b in enumerate(batches, first):
            state, out = ex.step(state, {k: jnp.asarray(v)
                                         for k, v in b.items()})
            for k in OUT_KEYS:
                rec[f"{k}/{s}"] = np.asarray(out[k])
            for k in STATE_KEYS:
                rec[f"{k}/{s}"] = np.asarray(state[k])
        return state


    def scenario(name):
        sc = SCENARIOS[name]
        batches = sc["batches"]()
        cfg = StreamJobConfig(window=VectorWindowSpec(**sc["spec"]),
                              batch_size=sc["B"], exchange=sc["exchange"])
        rec = {}
        if "split" in sc:
            na, nb = sc["ranks"]
            ex_a = StreamExecutor(cfg, mesh=MESHES[na])
            ex_b = StreamExecutor(cfg, mesh=MESHES[nb])
            state = run_steps(ex_a, ex_a.init_state(),
                              batches[:sc["split"]], 0, rec)
            state = ex_a.migrate_state(state, ex_b)
            run_steps(ex_b, state, batches[sc["split"]:], sc["split"], rec)
        else:
            ex = StreamExecutor(cfg, mesh=MESHES[sc["ranks"]])
            at = sc.get("snapshot", len(batches))
            state = run_steps(ex, ex.init_state(), batches[:at], 0, rec)
            if at < len(batches):
                # snapshot mid-stream, then run on from the restored state
                backup = ex.snapshot(state)
                rec["backup/panes"] = np.asarray(backup["panes"])
                state = ex.restore(backup)
                for k in STATE_KEYS:
                    rec[f"restored/{k}"] = np.asarray(state[k])
                run_steps(ex, state, batches[at:], at, rec)
        save(os.path.join(OUT, name + ".npz"), rec)


    os.makedirs(OUT, exist_ok=True)
    for name in SCENARIOS:
        if "source" in SCENARIOS[name]:
            continue
        try:
            scenario(name)
        except Exception:
            with open(os.path.join(OUT, name + ".error"), "w") as f:
                f.write(traceback.format_exc())
    print("JAX-DONE")
''')

TORCH_SCRIPT = textwrap.dedent('''
    import os
    import sys
    import time
    import traceback

    import numpy as np
    import torch.distributed as dist

    import repro_torch.streaming.executor as executor_module
    from repro_torch.launch.mesh import make_data_mesh, spawn_ranks
    from repro_torch.streaming import (StreamExecutor, StreamJobConfig,
                                       VectorWindowSpec)
    from repro_torch.streaming.state import (shard_state, state_from_numpy,
                                             state_to_numpy)
''') + SCENARIO_CODE + textwrap.dedent('''
    # emission must call no collective: count the transport's calls inside
    # the executor's emit, step by step
    CURRENT = {}
    _emit = executor_module.emit


    def _counting_emit(spec, state):
        transport = CURRENT["ex"].transport
        before = transport.calls
        result = _emit(spec, state)
        CURRENT["emit_calls"] = transport.calls - before
        return result


    executor_module.emit = _counting_emit


    def run_steps(ex, state, batches, first, rec):
        CURRENT["ex"] = ex
        for s, b in enumerate(batches, first):
            staged, count = ex.stage_batch(b)
            state, out = ex.step(state, staged, valid_count=count)
            for k in OUT_KEYS:
                rec[f"{k}/{s}"] = out[k].numpy().copy()
            for k in ("rows", "rounds"):
                rec[f"{k}/{s}"] = np.asarray(out[k])
            rec[f"emit_calls/{s}"] = np.asarray(CURRENT["emit_calls"])
            for k, v in state_to_numpy(state).items():
                rec[f"{k}/{s}"] = v
        return state


    def jax_state(name, step, jax_dir, deadline):
        path = os.path.join(jax_dir, name + ".npz")
        while not os.path.exists(path):
            if os.path.exists(os.path.join(jax_dir, name + ".error")):
                raise RuntimeError(f"the JAX run of {name} failed")
            if time.monotonic() > deadline:
                raise TimeoutError(f"no JAX state of {name}")
            time.sleep(0.2)
        with np.load(path) as f:
            return {k: f[f"{k}/{step}"] for k in STATE_KEYS}


    def scenario(name, rank, meshes, out_dir, jax_dir):
        sc = SCENARIOS[name]
        batches = sc["batches"]()
        cfg = StreamJobConfig(window=VectorWindowSpec(**sc["spec"]),
                              batch_size=sc["B"], exchange=sc["exchange"])
        rec = {}
        if "split" in sc:
            na, nb = sc["ranks"]
            ex_a = StreamExecutor(cfg, mesh=meshes[na], device="cpu")
            ex_b = StreamExecutor(cfg, mesh=meshes[nb], device="cpu")
            state = ex_a.init_state()
            if state is not None:
                state = run_steps(ex_a, state, batches[:sc["split"]], 0, rec)
            state = ex_a.migrate_state(state, ex_b)
            if state is not None:
                run_steps(ex_b, state, batches[sc["split"]:], sc["split"],
                          rec)
        else:
            n = sc["ranks"]
            ex = StreamExecutor(cfg, mesh=meshes[n], device="cpu")
            if ex.rank is not None:
                first = sc.get("start", 0)
                if "source" in sc:
                    whole = jax_state(sc["source"], first - 1, jax_dir,
                                      time.monotonic() + 300)
                    state = state_from_numpy(shard_state(whole, ex.rank, n),
                                             device="cpu")
                else:
                    state = ex.init_state()
                at = sc.get("snapshot", len(batches))
                state = run_steps(ex, state, batches[first:at], first, rec)
                if at < len(batches):
                    # snapshot mid-stream, then run on from the restored
                    # state; the live state must not move meanwhile
                    before = state_to_numpy(state)
                    backup = ex.snapshot(state)
                    rec["backup/panes"] = backup["panes"].numpy().copy()
                    restored = ex.restore(backup)
                    for k, v in state_to_numpy(restored).items():
                        rec[f"restored/{k}"] = v
                    for k, v in state_to_numpy(state).items():
                        assert np.array_equal(v, before[k]), k
                    run_steps(ex, restored, batches[at:], at, rec)
        save(os.path.join(out_dir, f"{name}-{rank}.npz"), rec)


    def rank_main(rank, world, device, names, out_dir, jax_dir):
        meshes = {8: make_data_mesh("cpu"),
                  4: make_data_mesh("cpu", ranks=range(4))}
        for name in names:
            if rank == 0:
                open(os.path.join(out_dir, name + ".started"), "w").close()
            scenario(name, rank, meshes, out_dir, jax_dir)
            dist.barrier()


    if __name__ == "__main__":
        out_dir, jax_dir = sys.argv[1], sys.argv[2]
        os.makedirs(out_dir, exist_ok=True)
        remaining = list(SCENARIOS)
        while remaining:
            try:
                spawn_ranks(rank_main, 8, backend="gloo", device="cpu",
                            args=(remaining, out_dir, jax_dir),
                            timeout_s=300)
                remaining = []
            except Exception:
                started = [n for n in remaining if os.path.exists(
                    os.path.join(out_dir, n + ".started"))]
                failed = started[-1] if started else remaining[0]
                with open(os.path.join(out_dir, failed + ".error"), "w") as f:
                    f.write(traceback.format_exc())
                remaining = remaining[remaining.index(failed) + 1:]
        print("TORCH-DONE")
''')

_NS = {"os": os}
exec(SCENARIO_CODE, _NS)
SCENARIOS = _NS["SCENARIOS"]
STATE_KEYS, OUT_KEYS, OOB_KEYS = (_NS["STATE_KEYS"], _NS["OUT_KEYS"],
                                  _NS["OOB_KEYS"])
NAMES = list(SCENARIOS)


class Runs:
    """Both runs' records, loaded per scenario."""

    def __init__(self, base: Path, logs: dict):
        self.base = base
        self.logs = logs

    def _fail(self, name, side, why):
        log = self.logs[side][-3000:]
        pytest.fail(f"{side} run of {name}: {why}\n--- log tail ---\n{log}")

    def load(self, name):
        """``(jax, ranks)``: the JAX run's arrays by key, and each port
        rank's (an empty dict where the rank took no part)."""
        source = SCENARIOS[name].get("source", name)
        jax_dir, torch_dir = self.base / "jax", self.base / "torch"
        for side, path in (("jax", jax_dir / source),
                           ("torch", torch_dir / name)):
            err = path.with_suffix(".error")
            if err.exists():
                self._fail(name, side, err.read_text())
        if not (jax_dir / f"{source}.npz").exists():
            self._fail(name, "jax", "no record")
        with np.load(jax_dir / f"{source}.npz") as f:
            jax = dict(f)
        ranks = []
        for r in range(8):
            path = torch_dir / f"{name}-{r}.npz"
            if not path.exists():
                self._fail(name, "torch", f"no record of rank {r}")
            with np.load(path) as f:
                ranks.append(dict(f))
        return jax, ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("spmd")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for side, script, args in (
            ("jax", JAX_SCRIPT, [base / "jax"]),
            ("torch", TORCH_SCRIPT, [base / "torch", base / "jax"])):
        path = base / f"{side}_run.py"
        path.write_text(script)
        log = open(base / f"{side}.log", "w")
        procs[side] = (subprocess.Popen(
            [sys.executable, str(path), *map(str, args)], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=base), log)
    deadline = time.monotonic() + TIMEOUT_S
    for side, (proc, log) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    logs = {side: (base / f"{side}.log").read_text() for side in procs}
    return Runs(base, logs)


def _steps(ranks):
    return sorted({int(k.split("/")[1]) for rec in ranks for k in rec
                   if k.startswith("valid/")})


def _members(ranks, s):
    """The ranks holding a shard at step ``s``, in shard order."""
    return [rec for rec in ranks if f"valid/{s}" in rec]


def _assert_close(got, want, exact, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **SUM_TOL)


def _held_steps(name, jax, ranks):
    steps = _steps(ranks)
    first = SCENARIOS[name].get("start", 0)
    n_jax = len({k for k in jax if k.startswith("valid/")})
    assert steps == list(range(first, n_jax)), (steps[:3], n_jax)
    return steps


@pytest.mark.parametrize("name", NAMES)
def test_outputs_match_jax(runs, name):
    """Every step's results (this rank's columns, put side by side),
    window ends and valid flags equal the JAX package's whole arrays."""
    jax, ranks = runs.load(name)
    exact = SCENARIOS[name]["exact"]
    for s in _held_steps(name, jax, ranks):
        held = _members(ranks, s)
        got = np.concatenate([rec[f"results/{s}"] for rec in held], axis=1)
        _assert_close(got, jax[f"results/{s}"], exact, f"results step {s}")
        for k in ("window_ends", "valid"):
            np.testing.assert_array_equal(held[0][f"{k}/{s}"],
                                          jax[f"{k}/{s}"],
                                          err_msg=f"{k} step {s}")
        assert int(held[0][f"rows/{s}"]) == int(jax[f"valid/{s}"].sum())


@pytest.mark.parametrize("name", NAMES)
def test_states_match_jax(runs, name):
    """After every step the whole state (``gather_state`` of the shards)
    equals the JAX package's."""
    jax, ranks = runs.load(name)
    exact = SCENARIOS[name]["exact"]
    for s in _held_steps(name, jax, ranks):
        whole = gather_state([{k: rec[f"{k}/{s}"] for k in STATE_KEYS}
                              for rec in _members(ranks, s)])
        _assert_close(whole["panes"], jax[f"panes/{s}"], exact,
                      f"panes step {s}")
        for k in STATE_KEYS[1:]:
            _assert_close(whole[k], jax[f"{k}/{s}"], True, f"{k} step {s}")


@pytest.mark.parametrize("name", NAMES)
def test_replicated_values_agree_and_emission_is_local(runs, name):
    """Every rank holds the same replicated state and outputs, runs the
    same number of emission rounds, and calls no collective while it
    emits: the loop depends only on replicated values."""
    _, ranks = runs.load(name)
    for s in _steps(ranks):
        held = _members(ranks, s)
        n = SCENARIOS[name]["ranks"]
        if isinstance(n, tuple):
            n = n[0] if s < SCENARIOS[name]["split"] else n[1]
        assert len(held) == n
        for k in ("window_ends", "valid", "rows", "rounds", *STATE_KEYS[1:]):
            for rec in held[1:]:
                np.testing.assert_array_equal(rec[f"{k}/{s}"],
                                              held[0][f"{k}/{s}"],
                                              err_msg=f"{k} step {s}")
        assert all(int(rec[f"emit_calls/{s}"]) == 0 for rec in held)


@pytest.mark.parametrize("name", ["spmd_reduce", "spmd_route"])
def test_snapshot_ring_layout_matches_jax(runs, name):
    """A snapshot mid-stream: the backup of shard i holds shard i - 1's
    panes, as the JAX package's ppermute leaves them."""
    jax, ranks = runs.load(name)
    at = SCENARIOS[name]["snapshot"] - 1
    panes = [rec[f"panes/{at}"] for rec in ranks]
    assert all(p.any() for p in panes)          # a layout to check
    for i, rec in enumerate(ranks):
        np.testing.assert_array_equal(rec["backup/panes"], panes[i - 1])
    np.testing.assert_array_equal(
        np.concatenate([rec["backup/panes"] for rec in ranks], axis=1),
        jax["backup/panes"])


@pytest.mark.parametrize("name", ["spmd_reduce", "spmd_route"])
def test_restore_of_snapshot_is_the_state(runs, name):
    """restore(snapshot(s)) == s on every shard; the run then goes on from
    the restored state (held against the JAX run by the tests above)."""
    jax, ranks = runs.load(name)
    at = SCENARIOS[name]["snapshot"] - 1
    for rec in ranks:
        for k in STATE_KEYS:
            np.testing.assert_array_equal(rec[f"restored/{k}"],
                                          rec[f"{k}/{at}"], err_msg=k)
    np.testing.assert_array_equal(
        np.concatenate([rec["restored/panes"] for rec in ranks], axis=1),
        jax["restored/panes"])


def test_route_overflow_counts_into_dropped_conflict(runs):
    """The skewed stream overflows C; the port drops and counts exactly
    what the JAX package does (its states match step by step above)."""
    jax, ranks = runs.load("overflow_route")
    last = _steps(ranks)[-1]
    got = int(ranks[0][f"dropped_conflict/{last}"])
    assert got == int(jax[f"dropped_conflict/{last}"]) > 0
    assert int(ranks[0][f"dropped_late/{last}"]) == 0


def test_out_of_range_keys_differ_between_plans_as_in_jax(runs):
    """Keys -1, K, K + K_loc and beyond reach both plans, which place them
    differently (the flat pane index against the routed owner); the port
    reproduces each plan's placement."""
    batches = _NS["_oob"]()
    keys = np.concatenate([b["key"][b["valid"]] for b in batches])
    assert set(OOB_KEYS) <= set(keys.tolist())
    finals = {}
    for name in ("oob_reduce", "oob_route"):
        jax, ranks = runs.load(name)
        last = _steps(ranks)[-1]
        got = np.concatenate([rec[f"panes/{last - 6}"] for rec in ranks[:4]],
                             axis=1)
        np.testing.assert_array_equal(got, jax[f"panes/{last - 6}"])
        finals[name] = got
    assert not np.array_equal(finals["oob_reduce"], finals["oob_route"])
