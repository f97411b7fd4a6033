"""The port's MoE on a mesh (``models/moe.py::_moe_sharded``, written with
``local_map``) against the JAX package's ``shard_map`` path.

Two runs at the same time, from the same numpy inputs (``DATA_CODE``,
which both execute):

* the JAX package's ``moe_ffn`` with the mesh registered, under ``jit``
  and ``value_and_grad``, on 4 and on 8 host devices
  (``--xla_force_host_platform_device_count``), one subprocess each;
* the port's ``moe_ffn`` on DTensors placed by ``sharding.rules`` over 4
  and over 8 gloo ranks on the CPU, spawned by ``launch.mesh.spawn_ranks``
  from a subprocess each.

Each case is a mesh, a number of experts (expert-parallel where it
divides the ``model`` axis, else tensor-parallel inside every expert) and
the experts' type (float32: FSDP, gathered over ``data``; bfloat16: not),
always computing in float32.  The function differentiated is
``sum(y * R) + 3 aux`` for a fixed random ``R``; the output, the aux loss
and the gradients of every parameter and of ``x`` agree at
``rtol=atol=1e-4``, but for the gradients of bfloat16 experts, which each
rank rounds to bfloat16 before the sum over ranks where XLA rounds after
it: those within ``2**-7`` of the largest (two bfloat16 roundings).
``capacity_factor`` is 1.0, so shards drop tokens.  The per-shard routing (``capacity(T_local)``) is held exactly in this
process.  F8: on ``2x2`` the batch shards, so the output differs from the
dense path's over the whole batch, and equals the reference's.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
TOL = dict(rtol=1e-4, atol=1e-4)
#: two roundings to bfloat16 (8 bits) of the partial sums
BF16_REL = 2.0 ** -7

DATA_CODE = textwrap.dedent('''
    import dataclasses
    import numpy as np

    B, S = 4, 32
    #: (name, mesh shape, axis names, experts, expert weights' type)
    CASES = {
        4: [("ep_fsdp_2x2", (2, 2), ("data", "model"), 4, "float32"),
            ("ep_bf16_2x2", (2, 2), ("data", "model"), 4, "bfloat16"),
            ("tp_fsdp_2x2", (2, 2), ("data", "model"), 3, "float32"),
            ("tp_bf16_2x2", (2, 2), ("data", "model"), 3, "bfloat16"),
            ("ep_fsdp_1x4", (1, 4), ("data", "model"), 4, "float32"),
            ("ep_fsdp_4x1", (4, 1), ("data", "model"), 4, "float32")],
        8: [("ep_fsdp_2x2x2", (2, 2, 2), ("pod", "data", "model"), 4,
             "float32"),
            ("ep_fsdp_2x4", (2, 4), ("data", "model"), 4, "float32"),
            ("tp_fsdp_4x2", (4, 2), ("data", "model"), 3, "float32")],
    }


    def case_cfg(get_config, experts):
        return dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                                   n_experts=experts, capacity_factor=1.0)


    def case_data(cfg, experts, seed=0):
        rng = np.random.RandomState(seed + experts)
        D, F = cfg.d_model, cfg.moe_d_ff
        p = {"router": rng.randn(D, experts) * D ** -0.5,
             "w_gate": rng.randn(experts, D, F) * D ** -0.5,
             "w_up": rng.randn(experts, D, F) * D ** -0.5,
             "w_down": rng.randn(experts, F, D) * F ** -0.5}
        p = {k: v.astype(np.float32) for k, v in p.items()}
        x = rng.randn(B, S, D).astype(np.float32)
        r = rng.randn(B, S, D).astype(np.float32)
        return p, x, r
''')

JAX_SCRIPT = DATA_CODE + textwrap.dedent('''
    import os
    import sys
    WORLD = int(sys.argv[2])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={WORLD}")
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.mesh import make_smoke_mesh
    from repro.models import moe
    from repro.sharding import constraints

    out = {}
    for name, shape, axes, experts, wdt in CASES[WORLD]:
        cfg = case_cfg(get_config, experts)
        p, x, r = case_data(cfg, experts)
        params = {k: jnp.asarray(v, jnp.float32 if k == "router"
                                 else getattr(jnp, wdt))
                  for k, v in p.items()}
        mesh = make_smoke_mesh(shape, axes)
        constraints.set_mesh(mesh)

        def f(params, x):
            y, aux = moe.moe_ffn(params, x, cfg, jnp.float32)
            return jnp.sum(y * r) + 3.0 * aux, (y, aux)

        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        constraints.set_mesh(None)
        out[f"{name}/y"] = np.asarray(y)
        out[f"{name}/aux"] = np.asarray(aux)
        out[f"{name}/g_x"] = np.asarray(gx)
        for k, g in gp.items():
            out[f"{name}/g_{k}"] = np.asarray(g, np.float32)
    np.savez(sys.argv[1], **out)
    print("JAX-DONE")
''')

TORCH_SCRIPT = DATA_CODE + textwrap.dedent('''
    import sys

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh, spawn_ranks
    from repro_torch.models import moe
    from repro_torch.sharding import constraints, rules


    def rank_main(rank, world, device):
        out = {}
        for name, shape, axes, experts, wdt in CASES[world]:
            cfg = case_cfg(get_config, experts)
            p, x, r = case_data(cfg, experts)
            mesh = make_smoke_mesh(shape, axes, "cpu")
            constraints.set_mesh(mesh)
            params = {}
            for k, v in p.items():
                t = torch.from_numpy(v).to(torch.float32 if k == "router"
                                           else getattr(torch, wdt))
                params[k] = rules.distribute(
                    t, mesh, rules.param_spec(mesh, k, t.shape)
                ).requires_grad_(True)
            spec = rules.batch_spec(mesh, x.shape)
            xd = rules.distribute(torch.from_numpy(x), mesh, spec)
            xd.requires_grad_(True)
            rd = rules.distribute(torch.from_numpy(r), mesh, spec)
            with constraints.replicated_constants():
                y, aux = moe.moe_ffn(params, xd, cfg, torch.float32)
                loss = (y * rd).sum() + 3.0 * aux
                grads = torch.autograd.grad(loss, [xd, *params.values()])
            constraints.set_mesh(None)
            out[f"{name}/y"] = y.full_tensor().detach().numpy()
            out[f"{name}/aux"] = aux.full_tensor().detach().numpy()
            for k, g in zip(["x", *params], grads):
                g = g.redistribute(g.device_mesh, [
                    torch.distributed.tensor.Replicate()] * mesh.ndim)
                out[f"{name}/g_{k}"] = g.to_local().float().numpy()
        return out if rank == 0 else None


    if __name__ == "__main__":
        world = int(sys.argv[2])
        ranks = spawn_ranks(rank_main, world, backend="gloo", device="cpu",
                            timeout_s=240)
        np.savez(sys.argv[1], **ranks[0])
        print("TORCH-DONE")
''')

DATA = {}
exec(DATA_CODE, DATA)
CASE_NAMES = [(world, c[0]) for world, cases in DATA["CASES"].items()
              for c in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: (jax, torch)}``: both packages' outputs by case, from four
    subprocesses run at once."""
    base = tmp_path_factory.mktemp("mesh_moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for world in DATA["CASES"]:
        for side, script in (("jax", JAX_SCRIPT), ("torch", TORCH_SCRIPT)):
            path = base / f"{side}_run.py"
            path.write_text(script)
            log = open(base / f"{side}{world}.log", "w")
            procs[side, world] = (subprocess.Popen(
                [sys.executable, str(path), str(base / f"{side}{world}.npz"),
                 str(world)], env=env, stdout=log, stderr=subprocess.STDOUT,
                cwd=base), log)
    try:
        for (side, world), (proc, log) in procs.items():
            rc = proc.wait(timeout=TIMEOUT_S)
            log.close()
            assert rc == 0, (side, world,
                             (base / f"{side}{world}.log").read_text()[-3000:])
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return {world: tuple(dict(np.load(base / f"{side}{world}.npz"))
                         for side in ("jax", "torch"))
            for world in DATA["CASES"]}


@pytest.mark.parametrize("world,case", CASE_NAMES)
def test_moe_sharded_equals_shard_map(runs, world, case):
    """Output, aux and every gradient equal to the reference's shard_map
    on the same mesh."""
    ref, got = runs[world]
    keys = sorted(k for k in ref if k.startswith(case + "/"))
    assert keys == sorted(k for k in got if k.startswith(case + "/"))
    assert len(keys) == 7
    bf16 = "bf16" in case
    for k in keys:
        tol = TOL
        if bf16 and k.split("/g_")[-1] in ("w_gate", "w_up", "w_down"):
            # a bfloat16 weight's gradient: each rank's partial rounds to
            # bfloat16 before the sum in the port, after it in XLA
            tol = dict(rtol=BF16_REL, atol=BF16_REL * np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **tol)


def _dense(experts, wdt):
    """The port's dense path over the whole batch, for one case's inputs."""
    cfg = DATA["case_cfg"](get_config, experts)
    p, x, _ = DATA["case_data"](cfg, experts)
    params = {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                        else getattr(torch, wdt))
              for k, v in p.items()}
    return moe.moe_ffn(params, torch.from_numpy(x), cfg, torch.float32)


def test_f8_sharded_batch_routes_per_shard(runs):
    """F8: with the batch sharded (2x2), each shard routes its own tokens
    with ``capacity(T_local)``: the output differs from the dense path's
    over the whole batch, and equals the reference's."""
    ref, got = runs[4]
    y_dense, _ = _dense(4, "float32")
    y = got["ep_fsdp_2x2/y"]
    np.testing.assert_allclose(y, ref["ep_fsdp_2x2/y"], **TOL)
    assert np.abs(y - y_dense.numpy()).max() > 1e-2


def test_unsharded_batch_equals_dense(runs):
    """On 1x4 every rank holds the whole batch: the routing and the output
    are the dense path's."""
    _, got = runs[4]
    y_dense, aux_dense = _dense(4, "float32")
    np.testing.assert_allclose(got["ep_fsdp_1x4/y"], y_dense.numpy(), **TOL)
    np.testing.assert_allclose(got["ep_fsdp_1x4/aux"], aux_dense.numpy(),
                               **TOL)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_local_routing_equals_jax(shards):
    """Each batch shard's routing at ``capacity(T_local)``: the experts,
    their slots and which choices are kept, exactly; the choices dropped
    grow as the shards shrink."""
    cfg = DATA["case_cfg"](get_config, 4)
    jcfg = DATA["case_cfg"](jax_get_config, 4)
    p, x, _ = DATA["case_data"](cfg, 4)
    B, S, D = x.shape
    dropped = 0
    for xs in np.split(x, shards):
        T = xs.shape[0] * S
        C = moe.capacity(T, cfg)
        assert C == jax_moe.capacity(T, jcfg)
        xt = xs.reshape(T, D)
        got = moe._route(torch.from_numpy(xt), torch.from_numpy(p["router"]),
                         cfg, C)
        want = jax_moe._route(jnp.asarray(xt), jnp.asarray(p["router"]),
                              jcfg, C)
        for i in (1, 2, 3, 4):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        dropped += int((~got[4]).sum())
    if shards > 1:
        assert dropped > 0
