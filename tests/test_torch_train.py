"""The port's training half against the JAX package's: AdamW, the train
step (remat, microbatches), and ``launch.train``'s resume.

Inputs are made with ``numpy.random.RandomState``; parameters come from
the JAX package's ``lm.init_params`` and AdamW's state from its
``AdamW.init``, carried across with ``models.convert``, so both packages
start every comparison from one state.  Each JAX train step is compiled
once for this module (the ``jax_steps`` fixture).

Tolerances, float32 throughout: AdamW alone at ``rtol=atol=1e-6`` (the
same formulas; the packages differ in fused multiply-adds and reduction
order only); the train step at ``rtol=1e-4`` for the loss and the grad
norm, the parameters at ``rtol=atol=1e-4``, and ``mu`` and ``nu`` at
``rtol=1e-4`` with an ``atol`` of 1e-4 of the largest magnitude in the
whole tree.  Gradients are sums in another order on each side: 1e-6 of
each array's largest entry for olmo, up to 2.7e-5 for rwkv6's bonus ``u``,
whose gradient runs back through the recurrence, and after a step whose
parameters differ that much, 2e-4 of ``u``'s largest entry, 2e-6 of the
tree's; ``nu`` holds squares spread over many decades, so a fixed
``atol`` would hide its small entries.  The
parameters take a fixed ``atol``: AdamW divides by ``sqrt(nu) + eps``, so
an entry whose gradient is near 0 (a key bias's slowest RoPE dimensions:
about 2e-8, against 2e-2 in the same array) moves by ``lr / eps`` times
its rounding, up to ``lr`` in all; at the reference's ``lr`` of 3e-4 that
stays under 1e-4, while a lost or wrong update (3e-4 an entry) does not.
The remat policies and the chunk checkpoints of ``chunked_time_scan``
recompute the same operations on the same inputs: equal gradients,
exactly.  Resume: the last loss within ``rel=1e-4``, as
``tests/test_sinks_and_ft_extras.py::test_train_resume_is_exact`` holds
the reference.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers, lm, mamba  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_numpy, opt_state_to_numpy, params_from_numpy,
    params_to_numpy)
from repro_torch.runtime.optimizer import AdamW  # noqa: E402

ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_RTOL = 1e-4
ARCHS = ["olmo-1b", "qwen2-1.5b", "mixtral-8x7b", "jamba-v0.1-52b",
         "rwkv6-7b"]
B, S = 2, 32
#: JAX compiles at a time: a few cores, the other test files run beside
COMPILE_THREADS = 4
#: the train step's optimizer: the reference's rate, and a warm-up of 2
#: steps, so the second step runs at the full rate
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


def _close(got, want, what, atol=None):
    """``got`` and ``want`` (numpy trees of one structure) within
    ``STEP_RTOL`` and ``atol`` (default: ``STEP_RTOL`` of the largest
    magnitude in ``want``)."""
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want], what
    if atol is None:
        atol = STEP_RTOL * max(float(np.abs(w).max()) for _, w in flat_want)
    for (path, g), (_, w) in zip(flat_got, flat_want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        np.testing.assert_allclose(
            g, w, rtol=STEP_RTOL, atol=atol,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _batches(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tok = rng.randint(0, vocab, size=(B, S + 1)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX train step of each (arch, microbatches), compiled once for
    the module (COMPILE_THREADS at a time: XLA compiles outside the
    interpreter lock), and each arch's initial parameters."""
    params = {arch: jax_lm.init_params(_cfgs(arch)[1], jax.random.PRNGKey(0),
                                       jnp.float32) for arch in ARCHS}
    batch = {k: jnp.asarray(v) for k, v in _batches(256, 1)[0].items()}

    def compile_one(key):
        arch, microbatches = key
        jcfg = _cfgs(arch)[1]
        opt = JaxAdamW(**OPT)
        state = {"params": params[arch], "opt": opt.init(params[arch]),
                 "step": jnp.zeros((), jnp.int32)}
        return jax.jit(jax_lm.make_train_step(
            jcfg, opt, compute_dtype=jnp.float32,
            microbatches=microbatches)).lower(state, batch).compile()

    keys = [(a, m) for a in ARCHS for m in (1, 2)]
    with concurrent.futures.ThreadPoolExecutor(COMPILE_THREADS) as pool:
        steps = dict(zip(keys, pool.map(compile_one, keys)))
    return lambda arch, microbatches: (steps[arch, microbatches],
                                       params[arch])


# -- AdamW alone --------------------------------------------------------------

def test_adamw_matches_jax_through_clip_warmup_and_cosine():
    """Five updates of a two-tensor tree with gradients whose global norm
    is above the clip (scaled every step), a warm-up of 2 steps and a
    cosine horizon of 4 (the fifth step past it, at the floor)."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(8, 16).astype(np.float32),
              "b": rng.randn(16).astype(np.float32)}
    grads = [{k: (3 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4, clip_norm=1.0)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for i, g in enumerate(grads):
        assert np.sqrt(sum((x ** 2).sum() for x in g.values())) > 1.0
        jp, js = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                             js)
        _, ts = opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32
        for name in params:
            for got, want in ((tp[name], jp[name]),
                              (ts["mu"][name], js["mu"][name]),
                              (ts["nu"][name], js["nu"][name])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           err_msg=f"step {i} {name}",
                                           **ADAMW_TOL)
        np.testing.assert_allclose(
            float(opt.schedule(ts["count"])),
            float(jopt.schedule(js["count"])), **ADAMW_TOL)


def test_adamw_updates_a_16_bit_parameter_in_float32():
    """The update is computed in float32 and cast back to the parameter's
    type; the moments stay float32."""
    rng = np.random.RandomState(1)
    p32 = rng.randn(32).astype(np.float32)
    g = rng.randn(32).astype(np.float32) * 0.1
    opt, jopt = AdamW(lr=1e-2), JaxAdamW(lr=1e-2)
    p = {"w": torch.from_numpy(p32).to(torch.bfloat16)}
    state = opt.init(p)
    assert state["mu"]["w"].dtype == torch.float32
    opt.update(p, {"w": torch.from_numpy(g).to(torch.bfloat16)}, state)
    jp = {"w": jnp.asarray(p32).astype(jnp.bfloat16)}
    jp, _ = jopt.update(jp, {"w": jnp.asarray(g).astype(jnp.bfloat16)},
                        jopt.init(jp))
    assert p["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(jp["w"]).astype(np.float32))


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_steps, arch, microbatches):
    """Two steps from one state: loss, grad norm, every parameter, ``mu``,
    ``nu``, ``count`` and ``step`` after each."""
    cfg, jcfg = _cfgs(arch)
    jstep, jparams = jax_steps(arch, microbatches)
    jstate = {"params": jparams, "opt": JaxAdamW(**OPT).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params_from_numpy(cfg, _np_tree(jparams), "cpu"),
             "opt": opt_state_from_numpy(cfg, _np_tree(jstate["opt"]),
                                         "cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    step = lm.make_train_step(cfg, AdamW(**OPT), compute_dtype=torch.float32,
                              microbatches=microbatches)
    for i, batch in enumerate(_batches(cfg.vocab_size, 2)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        what = f"{arch} M={microbatches} step {i + 1}"
        assert set(m) == set(jm) == {"loss", "ce_loss", "moe_aux",
                                     "grad_norm"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=STEP_RTOL, atol=1e-7,
                                       err_msg=f"{what} {k}")
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        _close(params_to_numpy(cfg, state["params"]),
               _np_tree(jstate["params"]), f"{what} params", atol=STEP_RTOL)
        opt_np = opt_state_to_numpy(cfg, state["opt"])
        jopt = _np_tree(jstate["opt"])
        assert opt_np["count"] == jopt["count"] == i + 1
        _close(opt_np["mu"], jopt["mu"], f"{what} mu")
        _close(opt_np["nu"], jopt["nu"], f"{what} nu")
    assert not any(p.requires_grad for p in state["params"].parameters())


def test_grad_transform_runs_before_the_norm_and_the_update():
    """``grad_transform`` sees the gradients by parameter name; the grad
    norm is taken after it (here: gradients halved)."""
    cfg, _ = _cfgs("olmo-1b")
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    seen = []

    def halve(grads):
        seen.append(sorted(grads))
        return {n: g * 0.5 for n, g in grads.items()}

    norms = []
    for transform in (None, halve):
        state, _ = train.make_trainer(cfg, steps=10, device="cpu")
        step = lm.make_train_step(cfg, AdamW(**OPT), torch.float32,
                                  grad_transform=transform)
        norms.append(float(step(state, batch)[1]["grad_norm"]))
    assert seen == [sorted(n for n, _ in state["params"].named_parameters())]
    np.testing.assert_allclose(norms[1], norms[0] / 2, rtol=1e-6)


# -- remat --------------------------------------------------------------------

def _grads(cfg, params, batch, policy):
    params.requires_grad_(True)
    loss, _ = lm.loss_fn(cfg, params, batch, torch.float32, policy)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    params.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ["olmo-1b", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "rwkv6-7b"])
def test_remat_policies_give_equal_gradients(arch):
    cfg, _ = _cfgs(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg.vocab_size, 1, seed=3)[0].items()}
    loss0, want = _grads(cfg, params, batch, "none")
    for policy in ("nothing", "dots"):
        loss, got = _grads(cfg, params, batch, policy)
        assert torch.equal(loss, loss0), policy
        for g, w in zip(got, want):
            assert torch.equal(g, w), policy


def test_remat_policies_keep_less_for_the_backward_pass():
    """What the forward pass keeps outside the checkpoints for the
    backward pass (saved tensors' bytes): each block's input under
    "nothing" and "dots" ("dots" keeps the products' outputs inside its
    checkpoint, which these hooks do not see), every intermediate under
    "none"; without trainable parameters nothing at all."""
    cfg, _ = _cfgs("olmo-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg.vocab_size, 1, seed=3)[0].items()}

    def kept(policy, trainable=True):
        params.requires_grad_(trainable)
        total = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: total.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            lm.loss_fn(cfg, params, batch, torch.float32, policy)
        params.requires_grad_(False)
        return sum(total)

    nothing, dots, none = (kept(p) for p in ("nothing", "dots", "none"))
    assert nothing == dots < none / 4
    assert kept("nothing", trainable=False) == 0


def test_remat_policy_is_checked():
    cfg, _ = _cfgs("olmo-1b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="remat_policy"):
        zeros = torch.zeros((1, 4), dtype=torch.int64)
        lm.loss_fn(cfg, params, {"tokens": zeros, "labels": zeros},
                   torch.float32, "everything")


def _no_checkpoint(fn, *args, use_reentrant=None, **kw):
    return fn(*args)


def test_chunk_checkpoints_give_equal_gradients(monkeypatch):
    """Mamba's selective scan over 32 steps in chunks of 8 (4 chunk
    checkpoints), then Jamba and rwkv6 whole: gradients with the chunk
    checkpoints equal those without."""
    cfg, _ = _cfgs("jamba-v0.1-52b")
    rng = np.random.RandomState(5)
    di, N = cfg.expand * cfg.d_model, cfg.d_state
    inputs = [torch.from_numpy(rng.randn(S, B, d).astype(np.float32))
              for d in (di, di, N, N)]
    inputs[1] = inputs[1].abs() * 0.1                 # dt > 0
    A = -torch.rand((di, N), generator=torch.Generator().manual_seed(5))

    def scan_grads():
        xs = tuple(t.clone().requires_grad_(True) for t in inputs)
        h0 = torch.zeros((B, di, N))
        h, ys = layers.chunked_time_scan(
            lambda h, x: mamba._ssm_step(h, *x, A), h0, xs, chunk=8)
        out = (ys.square().sum() + h.sum())
        return out.detach(), torch.autograd.grad(out, xs)

    def model_grads(arch):
        cfg, _ = _cfgs(arch)
        params = lm.init_params(cfg, torch.Generator().manual_seed(6))
        batch = {k: torch.from_numpy(v) for k, v in
                 _batches(cfg.vocab_size, 1, seed=6)[0].items()}
        return _grads(cfg, params, batch, "none")

    with_ckpt = [scan_grads(), model_grads("jamba-v0.1-52b"),
                 model_grads("rwkv6-7b")]
    monkeypatch.setattr(layers, "checkpoint", _no_checkpoint)
    without = [scan_grads(), model_grads("jamba-v0.1-52b"),
               model_grads("rwkv6-7b")]
    for (l1, g1), (l2, g2) in zip(with_ckpt, without):
        assert torch.equal(l1, l2)
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)


def test_chunked_time_scan_keeps_only_chunk_boundaries(monkeypatch):
    """With checkpoints, the backward pass keeps a carry and an input
    slice a chunk (32 steps in chunks of 8: 8 tensors); without, the
    tensors of every step."""
    saved = []

    def run():
        saved.clear()
        x = torch.randn(32, 3, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            layers.chunked_time_scan(
                lambda h, xt: (torch.tanh(h * xt), h), torch.ones(3), x,
                chunk=8)
        return len(saved)

    assert run() == 2 * 4
    monkeypatch.setattr(layers, "checkpoint", _no_checkpoint)
    assert run() >= 32


# -- the driver ---------------------------------------------------------------

def test_train_resume_is_exact(tmp_path):
    """``launch.train.main``: 30 straight steps == 15 steps + restore + 15,
    as the reference's test holds its driver."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    common = ["--arch", "olmo-1b", "--reduced", "--batch", "2", "--seq",
              "32", "--device", "cpu"]
    straight = train.main(common + ["--steps", "30", "--log-every", "30",
                                    "--ckpt-dir", d1, "--ckpt-every", "100"])
    train.main(common + ["--steps", "15", "--schedule-steps", "30",
                         "--log-every", "15", "--ckpt-dir", d2,
                         "--ckpt-every", "15"])
    resumed = train.main(common + ["--steps", "30", "--log-every", "30",
                                   "--ckpt-dir", d2, "--ckpt-every", "100",
                                   "--resume"])
    assert len(straight) == len(resumed) == 1
    assert straight[-1] == pytest.approx(resumed[-1], rel=1e-4)
    assert np.isfinite(straight[-1])


def test_train_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "olmo-1b", "--reduced", "--steps", "1"])


def test_make_trainer_needs_a_card_unless_given_a_device(monkeypatch):
    """``make_trainer`` with no device names the card, as every entry point
    does (``devices.resolve_device``): with none it raises rather than
    train on the CPU unasked; ``"cpu"`` and ``"meta"`` still work."""
    cfg = get_config("olmo-1b").reduced()
    for device in ("cpu", "meta"):
        state, _ = train.make_trainer(cfg, steps=10, device=device)
        assert state["step"].device.type == device
        assert all(p.device.type == device
                   for p in state["params"].parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_trainer(cfg, steps=10)
