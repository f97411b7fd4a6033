"""Training on a mesh: the port's train step over DTensors on 4 gloo ranks
against the JAX package's on 4 host devices, and ``launch.train --mesh``.

* From one state (the JAX package's ``lm.init_params``, saved as numpy),
  the JAX package's train step, jitted with the state placed by its
  ``state_sharding`` and the mesh registered (as its ``launch.train``
  does for ``--mesh``), runs in a subprocess on 4 host devices; the
  port's, with the state placed by its rules, on 4 gloo ranks spawned
  from a second subprocess.  Reduced olmo-1b and mixtral-8x7b (the MoE's
  sharded path with a sharded batch: each shard routes its own tokens)
  on ``2x2``, mixtral with 2 microbatches too, and mixtral and jamba
  (Mamba's scans over DTensors) on ``1x4``.
  Every step's loss and grad norm at ``rtol=1e-4``, the parameters after
  the last step at ``rtol=atol=1e-4`` (``tests/test_torch_train.py``
  says why a fixed ``atol``).
* ``launch.train.main --mesh 2x2`` (olmo) gives the losses of the run
  without a mesh, and so does a run resumed from a checkpoint restored
  into the placements.  On ``1x4`` every rank holds the whole batch, so
  mixtral's routing and loss are the dense path's.
* ``--mesh 4`` (a mesh without ``"model"``) raises ``KeyError`` in both
  packages before any rank starts.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime.data import SyntheticLMData  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4

DATA_CODE = textwrap.dedent('''
    import numpy as np

    B, S, STEPS, SEED = 4, 16, 2, 0
    TIMEOUT_S = 600
    #: (name, arch, mesh shape, microbatches)
    CASES = [("olmo_2x2", "olmo-1b", (2, 2), 1),
             ("mixtral_2x2", "mixtral-8x7b", (2, 2), 1),
             ("mixtral_2x2_mb2", "mixtral-8x7b", (2, 2), 2),
             ("mixtral_1x4", "mixtral-8x7b", (1, 4), 1),
             ("jamba_1x4", "jamba-v0.1-52b", (1, 4), 1)]
    AXES = ("data", "model")
    OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)


    def flat(tree, prefix=""):
        """``{"a/b": array}`` of a nested dict of arrays."""
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and not v:    # a parameter-free norm
                out[f"{prefix}{k}/"] = np.zeros(0)
            elif isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = v
        return out


    def unflat(arrays, prefix):
        tree = {}
        for k, v in arrays.items():
            if not k.startswith(prefix):
                continue
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            if leaf:
                node[leaf] = np.asarray(v)
        return tree
''')

JAX_SCRIPT = DATA_CODE + textwrap.dedent('''
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import lm
    from repro.runtime.data import SyntheticLMData
    from repro.runtime.optimizer import AdamW
    from repro.sharding import constraints
    from repro.sharding.rules import state_sharding

    init = dict(np.load(sys.argv[2]))
    out = {}
    for name, arch, shape, mb in CASES:
        cfg = get_config(arch).reduced()
        mesh = make_smoke_mesh(shape, AXES)
        constraints.set_mesh(mesh)
        opt = AdamW(**OPT)
        params = jax.tree.map(jnp.asarray, unflat(init, arch + "/"))
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        sh = state_sharding(mesh, jax.eval_shape(lambda: state))
        state = jax.tree.map(jax.device_put, state, sh)
        step = jax.jit(lm.make_train_step(cfg, opt, jnp.float32,
                                          microbatches=mb))
        data = SyntheticLMData(cfg.vocab_size, B, S, seed=SEED)
        losses, norms = [], []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        constraints.set_mesh(None)
        out[f"{name}/loss"] = np.asarray(losses)
        out[f"{name}/grad_norm"] = np.asarray(norms)
        for k, v in flat(jax.tree.map(np.asarray, state["params"])).items():
            out[f"{name}/params/{k}"] = v
    from repro.launch import train
    try:
        train.main(["--arch", "olmo-1b", "--reduced", "--steps", "1",
                    "--mesh", "4"])
    except KeyError as e:
        out["mesh4_error"] = np.asarray(repr(e.args))
    np.savez(sys.argv[1], **out)
    print("JAX-DONE")
''')

TORCH_SCRIPT = DATA_CODE + textwrap.dedent('''
    import sys

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh, spawn_ranks
    from repro_torch.models import lm
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.runtime.data import SyntheticLMData
    from repro_torch.runtime.optimizer import AdamW
    from repro_torch.sharding import constraints, rules


    def rank_main(rank, world, device, init_path, group):
        init = dict(np.load(init_path))
        out = {}
        for name, arch, shape, mb in CASES[group::2]:
            cfg = get_config(arch).reduced()
            mesh = make_smoke_mesh(shape, AXES, "cpu")
            constraints.set_mesh(mesh)
            opt = AdamW(**OPT)
            params = params_from_numpy(cfg, unflat(init, arch + "/"))
            rules.distribute_module(params, mesh,
                                    rules.param_sharding(mesh, params))
            state = {"params": params, "opt": opt.init(params),
                     "step": rules.distribute(
                         torch.zeros((), dtype=torch.int32), mesh, ())}
            step = lm.make_train_step(cfg, opt, torch.float32,
                                      microbatches=mb)
            data = SyntheticLMData(cfg.vocab_size, B, S, seed=SEED)
            losses, norms = [], []
            for i in range(STEPS):
                state, m = step(state, train.batch_on(data.batch_at(i),
                                                      "cpu", mesh))
                losses.append(train.value(m["loss"]))
                norms.append(train.value(m["grad_norm"]))
            constraints.set_mesh(None)
            out[f"{name}/loss"] = np.asarray(losses)
            out[f"{name}/grad_norm"] = np.asarray(norms)
            for k, p in state["params"].named_parameters():
                out[f"{name}/params/{k}"] = p.full_tensor().detach().numpy()
        return out if rank == 0 else None


    if __name__ == "__main__":
        ranks = spawn_ranks(rank_main, 4, backend="gloo", device="cpu",
                            args=(sys.argv[2], int(sys.argv[3])),
                            timeout_s=TIMEOUT_S)
        np.savez(sys.argv[1], **ranks[0])
        print("TORCH-DONE")
''')

DATA = {}
exec(DATA_CODE, DATA)


def _init_arrays() -> dict:
    """The JAX package's initial parameters of each arch, as numpy."""
    out = {}
    for arch in sorted({c[1] for c in DATA["CASES"]}):
        cfg = jax_get_config(arch).reduced()
        tree = jax.tree.map(np.asarray, jax_lm.init_params(
            cfg, jax.random.PRNGKey(DATA["SEED"])))
        out.update({f"{arch}/{k}": v for k, v in DATA["flat"](tree).items()})
    return out


COMMON = ["--arch", "olmo-1b", "--reduced", "--device", "cpu", "--batch",
          "4", "--seq", "16", "--log-every", "1", "--schedule-steps", "4"]


def _main_runs(ckpt: str):
    """``launch.train.main``: 2 steps on 2x2 with a checkpoint, then
    ``--resume`` to step 4 from a fresh state restored into the
    placements; and 4 steps without a mesh."""
    first = train.main(COMMON + ["--steps", "2", "--mesh", "2x2",
                                 "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    resumed = train.main(COMMON + ["--steps", "4", "--mesh", "2x2",
                                   "--ckpt-dir", ckpt, "--resume"])
    one = train.main(COMMON + ["--steps", "4"])
    return first, resumed, one


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, torch, main)``: both packages' outputs by case (the JAX
    package's in one subprocess, the port's cases in two, every rank
    group at once), and :func:`_main_runs`, run meanwhile."""
    base = tmp_path_factory.mktemp("mesh_train")
    np.savez(base / "init.npz", **_init_arrays())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for side, script, extra in (("jax", JAX_SCRIPT, []),
                                ("torch0", TORCH_SCRIPT, ["0"]),
                                ("torch1", TORCH_SCRIPT, ["1"])):
        path = base / f"{side}_run.py"
        path.write_text(script)
        log = open(base / f"{side}.log", "w")
        procs[side] = (subprocess.Popen(
            [sys.executable, str(path), str(base / f"{side}.npz"),
             str(base / "init.npz"), *extra], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=base), log)
    try:
        main = _main_runs(str(base / "ckpt"))
        for side, (proc, log) in procs.items():
            rc = proc.wait(timeout=DATA["TIMEOUT_S"])
            log.close()
            assert rc == 0, (side, (base / f"{side}.log").read_text()[-3000:])
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    got = {}
    for side in ("torch0", "torch1"):
        got.update(np.load(base / f"{side}.npz"))
    return dict(np.load(base / "jax.npz")), got, main


@pytest.mark.parametrize("case", [c[0] for c in DATA["CASES"]])
def test_mesh_train_step_equals_jax(runs, case):
    ref, got, _ = runs
    arch = next(c[1] for c in DATA["CASES"] if c[0] == case)
    cfg = get_config(arch).reduced()
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[f"{case}/{k}"], ref[f"{case}/{k}"],
                                   rtol=RTOL, err_msg=k)
    want = params_from_numpy(cfg, DATA["unflat"](ref, f"{case}/params/"))
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[f"{case}/params/{name}"], p.numpy(),
                                   rtol=RTOL, atol=RTOL, err_msg=name)


def test_f8_mixtral_mesh_loss_differs_from_one_process(runs):
    """F8 in training: on 2x2 the MoE routes per batch shard, so the first
    loss (the same parameters) is the reference's, not the one-process
    dense path's; on 1x4 it is both."""
    ref, got, _ = runs
    cfg = get_config("mixtral-8x7b").reduced()
    params = params_from_numpy(cfg, DATA["unflat"](_init_arrays(),
                                                   "mixtral-8x7b/"))
    batch = train.batch_on(SyntheticLMData(
        cfg.vocab_size, DATA["B"], DATA["S"], seed=DATA["SEED"]).batch_at(0),
        "cpu")
    with torch.no_grad():
        dense = float(lm.loss_fn(cfg, params, batch, torch.float32)[0])
    np.testing.assert_allclose(got["mixtral_1x4/loss"][0], dense, rtol=RTOL)
    assert abs(got["mixtral_2x2/loss"][0] - dense) > 2 * RTOL * abs(dense)
    np.testing.assert_allclose(got["mixtral_2x2/loss"][0],
                               ref["mixtral_2x2/loss"][0], rtol=RTOL)


def test_train_main_on_a_mesh_equals_one_process(runs):
    """olmo's math is the same on 2x2 and in one process."""
    first, _, one = runs[2]
    np.testing.assert_allclose(first, one[:2], rtol=RTOL)


def test_train_main_mesh_resume_restores_into_the_placements(runs):
    """Steps 3 and 4 after a restore into the 2x2 placements are the
    straight run's."""
    _, resumed, one = runs[2]
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, one[2:], rtol=RTOL)


def test_mesh_without_model_axis_raises_like_jax(runs):
    """``--mesh 4``: the rule table reads the ``"model"`` axis, in both
    packages (the reference's on its 4 host devices), before any step."""
    ref = runs[0]
    with pytest.raises(KeyError) as port:
        train.main(["--arch", "olmo-1b", "--reduced", "--steps", "1",
                    "--mesh", "4", "--device", "cpu"])
    assert repr(port.value.args) == str(ref["mesh4_error"])
    assert port.value.args == ("model",)
