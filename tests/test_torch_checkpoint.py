"""The port's ``runtime.checkpoint.CheckpointManager`` against the JAX
package's: the same files and protocol (``arrays.npz``, ``meta.json``,
``COMMIT``, then the rename), so each package restores what the other
wrote; commit and torn-write visibility; GC; the IMap tier; and an
asynchronous save followed at once by a train step.

Values are restored exactly (``assert_array_equal``): a checkpoint is a
copy, never a computation.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime.checkpoint import (  # noqa: E402
    CheckpointManager as JaxCheckpointManager)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_to_numpy, params_to_numpy)
from repro_torch.runtime import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.data import SyntheticLMData  # noqa: E402
from repro_torch.state import IMapService  # noqa: E402


def _state(w=None, step=7):
    w = np.arange(12.0, dtype=np.float32).reshape(3, 4) if w is None else w
    return {"params": {"w": torch.from_numpy(w.copy())},
            "step": torch.tensor(step, dtype=torch.int32)}


def _zeros_like(state):
    return {"params": {"w": torch.zeros_like(state["params"]["w"])},
            "step": torch.zeros((), dtype=torch.int32)}


def test_checkpoint_manager_roundtrip(tmp_path):
    """``tests/test_sinks_and_ft_extras.py::test_checkpoint_manager_
    roundtrip`` on the port: keep=2 collects step 7; the restore copies
    into the given tensors, in their types."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (7, 14, 21):
        mgr.save(state, step)
    assert mgr.all_steps() == [14, 21]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000014",
                                            "step_0000000021"]
    like = _zeros_like(state)
    w = like["params"]["w"]
    restored = mgr.restore(like)
    assert restored is like and restored["params"]["w"] is w
    np.testing.assert_array_equal(w.numpy(), state["params"]["w"].numpy())
    assert restored["step"].dtype == torch.int32
    assert int(restored["step"]) == 7
    assert sorted(os.listdir(tmp_path / "step_0000000021")) == [
        "COMMIT", "arrays.npz", "meta.json"]


def test_each_package_restores_what_the_other_wrote(tmp_path):
    """Same tree, same leaf names (``params/w``, ``step``), same files."""
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w)}, "step": jnp.int32(5)}
    JaxCheckpointManager(str(tmp_path / "jax")).save(jstate, 5)
    got = CheckpointManager(str(tmp_path / "jax")).restore(
        _zeros_like(_state(w)))
    np.testing.assert_array_equal(got["params"]["w"].numpy(), w)
    assert int(got["step"]) == 5

    CheckpointManager(str(tmp_path / "port")).save(_state(w, 9), 9)
    mgr = JaxCheckpointManager(str(tmp_path / "port"))
    assert mgr.latest_step() == 9
    back = mgr.restore(jax.tree.map(jnp.zeros_like, jstate))
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]), w)
    assert int(back["step"]) == 9


def test_only_committed_checkpoints_are_visible(tmp_path):
    """A torn write (a ``.tmp_step_*`` directory, or a ``step_*`` without
    ``COMMIT``) is invisible to ``latest_step``, ``all_steps`` and the
    default restore, in both packages."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(_state(step=3), 3)
    torn = tmp_path / ".tmp_step_0000000004"
    torn.mkdir()
    np.savez(torn / "arrays.npz", **{"params/w": np.ones((3, 4)),
                                     "step": np.int32(4)})
    uncommitted = tmp_path / "step_0000000005"
    uncommitted.mkdir()
    (uncommitted / "meta.json").write_text('{"step": 5}')
    for m in (mgr, JaxCheckpointManager(str(tmp_path), keep=5)):
        assert m.all_steps() == [3] and m.latest_step() == 3
    assert int(mgr.restore(_zeros_like(_state()))["step"]) == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_restore_names_a_missing_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(), 1)
    like = _zeros_like(_state())
    like["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra"):
        mgr.restore(like)


def test_imap_tier_restores_and_is_collected(tmp_path):
    """The in-memory tier: every array in ``__ckpt.<step>``, restored
    without the disk, after the loss of a member too (backup promotion);
    GC destroys the IMaps of collected steps."""
    svc = IMapService([0, 1, 2], partition_count=32, backup_count=1)
    mgr = CheckpointManager(str(tmp_path), keep=2, imap_service=svc)
    rng = np.random.RandomState(1)
    states = {s: _state(rng.randn(3, 4).astype(np.float32), s)
              for s in (10, 20, 30)}
    for s, st in states.items():
        mgr.save(st, s)
    assert mgr.all_steps() == [20, 30]
    names = {n for n in svc.map_names() if n.startswith("__ckpt.")}
    assert names == {"__ckpt.20", "__ckpt.30"}
    svc.kill_member(0)
    for s in (20, 30):
        got = mgr.restore_from_imap(_zeros_like(states[s]), s)
        np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                      states[s]["params"]["w"].numpy())
        assert int(got["step"]) == s
    with pytest.raises(KeyError):
        mgr.restore_from_imap(_zeros_like(states[10]), 10)


def _train_state_numpy(cfg, state):
    return (params_to_numpy(cfg, state["params"]),
            opt_state_to_numpy(cfg, state["opt"]), int(state["step"]))


def _assert_tree_equal(got, want):
    for (p, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                              jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))


def test_async_save_then_step_restores_the_state_at_the_save(
        tmp_path, monkeypatch):
    """An asynchronous save, then at once a train step (which updates the
    parameters and AdamW's state in place), then the restore: the state at
    the save, exactly.  The writer thread is held until the step is done,
    so a save that kept references to the live tensors (``.cpu()`` of a
    CPU tensor is the tensor) would write the state after the step."""
    cfg = get_config("olmo-1b").reduced()
    state, step_fn = train.make_trainer(cfg, steps=10,
                                        compute_dtype=torch.float32,
                                        device="cpu")
    data = SyntheticLMData(cfg.vocab_size, 2, 32)
    state, _ = step_fn(state, train.batch_on(data.batch_at(0), "cpu"))
    at_save = _train_state_numpy(cfg, state)

    stepped = threading.Event()
    savez = np.savez

    def held_savez(*args, **kw):
        assert stepped.wait(30), "the step did not finish"
        return savez(*args, **kw)

    monkeypatch.setattr(ckpt_mod.np, "savez", held_savez)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state, 1)
    state, _ = step_fn(state, train.batch_on(data.batch_at(1), "cpu"))
    after = _train_state_numpy(cfg, state)
    stepped.set()
    mgr.wait()
    assert after[2] == 2 and not np.array_equal(
        after[0]["embed"], at_save[0]["embed"])

    fresh, _ = train.make_trainer(cfg, steps=10, compute_dtype=torch.float32,
                                  seed=1, device="cpu")
    restored = _train_state_numpy(cfg, mgr.restore(fresh))
    _assert_tree_equal(restored[:2], at_save[:2])
    assert restored[2] == 1
