"""The port's ``runtime.compression`` against the JAX package's.

``quantize_int8``, ``dequantize_int8`` and ``ErrorFeedback`` run in this
process on the same numpy inputs in both packages.  ``compressed_psum``
runs twice at the same time, from the same numpy inputs (``DATA_CODE``,
which both runs execute), as ``tests/test_compression_spmd.py`` builds it:

* the JAX package's ``compressed_psum`` under ``shard_map`` on 8 host
  devices (``--xla_force_host_platform_device_count=8``), in one
  subprocess;
* the port's over 8 gloo ranks on the CPU, spawned by
  ``repro_torch.launch.mesh.spawn_ranks`` from a second subprocess.

Both save their outputs to ``.npz`` and the tests compare.  Tolerances:
codes and scales exactly (both divide the same float32 values by the same
float32 scale and round half to even); the compressed reduce exactly (the
int32 sum is exact, then the same two float32 operations); the exact
reduce (a float32 mean in another order) at ``rtol=1e-6``; the 60-step
regression's losses at ``rtol=1e-5`` and ``atol=1e-6`` (1e-7 of the first
step's loss of 12.5) between the packages: 60 steps of float32 gradients
summed in another order, the last losses a small difference of large
products; and within the reference's own bounds (compressed loss under
0.05, within 0.02 of the exact run's).
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.runtime import compression as jax_comp  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
WORLD = 8
STEPS = 60

DATA_CODE = textwrap.dedent('''
    import numpy as np

    # tests/test_compression_spmd.py's draws, in its order
    rng = np.random.RandomState(0)
    G_LOCAL = rng.randn(8, 64, 64).astype(np.float32)
    W_TRUE = rng.randn(16, 1).astype(np.float32)
    X = rng.randn(256, 16).astype(np.float32)
    Y = X @ W_TRUE
    STEPS, LR = 60, 0.05
''')

JAX_SCRIPT = DATA_CODE + textwrap.dedent('''
    import os
    import sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.launch.mesh import make_smoke_mesh
    from repro.runtime.compression import compressed_psum

    mesh = make_smoke_mesh((8,), ("data",))
    g = jnp.asarray(G_LOCAL)
    ex = jax.jit(shard_map(lambda g: jax.lax.pmean(g, "data"), mesh,
                           P("data"), P("data")))(g)
    cp = jax.jit(shard_map(lambda g: compressed_psum(g, "data"), mesh,
                           P("data"), P("data")))(g)
    X_, Y_ = jnp.asarray(X), jnp.asarray(Y)

    def train(compressed):
        def step_fn(w, Xs, ys):
            def inner(w, Xb, yb):
                g = jax.grad(lambda w: jnp.mean((Xb @ w - yb) ** 2))(w)
                return (compressed_psum(g, "data") if compressed
                        else jax.lax.pmean(g, "data"))
            g = shard_map(inner, mesh, (P(), P("data"), P("data")),
                          P())(w, Xs, ys)
            return w - LR * g
        step = jax.jit(step_fn)
        w, losses = jnp.zeros((16, 1), jnp.float32), []
        for _ in range(STEPS):
            w = step(w, X_, Y_)
            losses.append(float(jnp.mean((X_ @ w - Y_) ** 2)))
        return np.asarray(w), np.asarray(losses, np.float32)

    w_exact, l_exact = train(False)
    w_comp, l_comp = train(True)
    np.savez(sys.argv[1], exact=np.asarray(ex), compressed=np.asarray(cp),
             w_exact=w_exact, l_exact=l_exact, w_comp=w_comp, l_comp=l_comp)
    print("JAX-DONE")
''')

TORCH_SCRIPT = DATA_CODE + textwrap.dedent('''
    import sys

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.runtime.compression import compressed_psum


    def mean(g):
        dist.all_reduce(g)
        return g / dist.get_world_size()


    def rank_main(rank, world, device):
        g = torch.from_numpy(G_LOCAL[rank].copy())
        out = {"exact": mean(g.clone()).numpy(),
               "compressed": compressed_psum({"g": g})["g"].numpy()}
        Xb = torch.from_numpy(X[rank * 32:(rank + 1) * 32])
        yb = torch.from_numpy(Y[rank * 32:(rank + 1) * 32])
        Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
        for name, reduce in (("exact", mean), ("comp", compressed_psum)):
            w, losses = torch.zeros((16, 1)), []
            for _ in range(STEPS):
                w.requires_grad_(True)
                loss = torch.mean((Xb @ w - yb) ** 2)
                (g,) = torch.autograd.grad(loss, [w])
                w = (w - LR * reduce(g)).detach()
                losses.append(float(torch.mean((Xt @ w - Yt) ** 2)))
            out["w_" + name] = w.numpy()
            out["l_" + name] = np.asarray(losses, np.float32)
        return out


    if __name__ == "__main__":
        ranks = spawn_ranks(rank_main, 8, backend="gloo", device="cpu",
                            timeout_s=240)
        np.savez(sys.argv[1], **{f"{k}/{r}": v for r, out in enumerate(ranks)
                                 for k, v in out.items()})
        print("TORCH-DONE")
''')


DATA = {}
exec(DATA_CODE, DATA)


# -- quantize, dequantize, error feedback -------------------------------------

@pytest.mark.parametrize("shape,scale", [((64, 64), 1.0), ((1000,), 1e-3),
                                         ((3, 5, 7), 100.0)])
def test_quantize_int8_equals_jax(shape, scale):
    x = (np.random.RandomState(0).randn(*shape) * scale).astype(np.float32)
    q, s = compression.quantize_int8(torch.from_numpy(x))
    jq, js = jax_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(jax_comp.dequantize_int8(jq, js)))


def test_quantize_int8_rounds_half_to_even_and_keeps_zero():
    """127 * x / max: values at exact halves of a code round to even, as
    ``jnp.round`` does; an all-zero tensor takes the 1e-12 floor."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = compression.quantize_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    q, s = compression.quantize_int8(torch.zeros(4))
    assert float(s) == pytest.approx(1e-12 / 127) and not q.any()


def test_error_feedback_equals_jax():
    """``tests/test_sinks_and_ft_extras.py::test_gradient_compression_
    error_feedback`` on the port (RMS error under 2 % of the spread; the
    mean of 20 applied gradients within 3e-3 of the true one), with every
    applied gradient and residual equal to the JAX package's, on a tree of
    two tensors."""
    rng = np.random.RandomState(0)
    g = {"a": rng.randn(64, 64).astype(np.float32),
         "b": (rng.randn(17) * 1e-3).astype(np.float32)}
    q, s = compression.quantize_int8(torch.from_numpy(g["a"]))
    deq = compression.dequantize_int8(q, s).numpy()
    assert np.sqrt(np.mean((deq - g["a"]) ** 2)) < 0.02 * g["a"].std()
    ef, jef = compression.ErrorFeedback(), jax_comp.ErrorFeedback()
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    resid, jresid = ef.init(tg), jef.init(jg)
    applied = {k: np.zeros_like(v) for k, v in g.items()}
    for _ in range(20):
        out, resid = ef.apply(tg, resid)
        jout, jresid = jef.apply(jg, jresid)
        for k in g:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(resid[k].numpy(),
                                          np.asarray(jresid[k]))
            applied[k] += out[k].numpy()
    np.testing.assert_allclose(applied["a"] / 20, g["a"], atol=3e-3)


# -- compressed_psum over 8 ranks ---------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs' outputs: ``(jax, torch)`` dicts of arrays."""
    base = tmp_path_factory.mktemp("compression")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for side, script in (("jax", JAX_SCRIPT), ("torch", TORCH_SCRIPT)):
        path = base / f"{side}_run.py"
        path.write_text(script)
        log = open(base / f"{side}.log", "w")
        procs[side] = (subprocess.Popen(
            [sys.executable, str(path), str(base / f"{side}.npz")], env=env,
            stdout=log, stderr=subprocess.STDOUT, cwd=base), log)
    deadline = time.monotonic() + TIMEOUT_S
    out = {}
    for side, (proc, log) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        text = (base / f"{side}.log").read_text()
        if proc.returncode != 0 or not (base / f"{side}.npz").exists():
            pytest.fail(f"{side} run failed ({proc.returncode}):\n"
                        f"{text[-3000:]}")
        with np.load(base / f"{side}.npz") as f:
            out[side] = dict(f)
    return out["jax"], out["torch"]


def test_compressed_psum_over_8_gloo_ranks_equals_shard_map(runs):
    jax_out, ranks = runs
    for name, exact in (("compressed", True), ("exact", False)):
        got = np.stack([ranks[f"{name}/{r}"] for r in range(WORLD)])
        want = jax_out[name]
        assert got.shape == want.shape == (WORLD, 64, 64)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        # every rank holds the same reduced tensor
        np.testing.assert_array_equal(got, np.broadcast_to(got[0], got.shape))
    # the reference's bound: within one quantization step of the mean
    err = np.abs(ranks["exact/0"] - ranks["compressed/0"]).max()
    assert err <= np.abs(DATA["G_LOCAL"]).max() / 127.0 + 1e-6


def test_compressed_regression_converges_as_in_jax(runs):
    """The reference's 60-step regression with compressed data-parallel
    gradients: within 2 % of the uncompressed run's loss, and each run's
    losses equal to the JAX package's, every step."""
    jax_out, ranks = runs
    for name in ("exact", "comp"):
        for r in range(WORLD):
            np.testing.assert_array_equal(ranks[f"w_{name}/{r}"],
                                          ranks[f"w_{name}/0"])
        assert ranks[f"l_{name}/0"].shape == (STEPS,)
        np.testing.assert_allclose(ranks[f"l_{name}/0"],
                                   jax_out[f"l_{name}"], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    l_exact, l_comp = ranks["l_exact/0"][-1], ranks["l_comp/0"][-1]
    assert l_comp < 0.05, l_comp
    assert abs(l_comp - l_exact) < 0.02, (l_exact, l_comp)
