"""The port's MoE feed-forward (``models/moe.py``) and the MoE families
(mixtral-8x7b, phi3.5-moe) against the JAX package's.

Routing is held exactly: the experts chosen, their slots in each expert
(the cumsum position, clamped to ``C - 1`` for a dropped choice) and which
choices are kept.  Float outputs, gates and the auxiliary loss at
``rtol=atol=1e-4`` in float32.  ``capacity_factor`` is lowered where a
case must drop tokens.  Inputs are made with ``numpy.random.RandomState``;
parameters come from the JAX package's ``lm.init_params`` through
``models.convert``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import BatchedLMServer as JaxServer  # noqa: E402
from repro.models import lm as jax_lm, moe as jax_moe  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, moe, transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_to_numpy, params_from_numpy)

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32
MOE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **fields):
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **fields)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


@functools.cache
def _jax_params(jcfg, seed=0):
    return jax_lm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)


def _port_params(cfg, jcfg, seed=0):
    return params_from_numpy(cfg, _np_tree(_jax_params(jcfg, seed)),
                             device="cpu")


def _ffn(jcfg):
    """Layer 0's MoE parameters: the JAX tree and the port's tensors."""
    jp = jax.tree.map(lambda a: a[0], _jax_params(jcfg)["groups"]["b0"]["ffn"])
    return jp, {k: torch.from_numpy(np.array(a))
                for k, a in _np_tree(jp).items()}


@pytest.mark.parametrize("n_tokens", [1, 8, 100, 1000])
def test_capacity_matches_jax(n_tokens):
    for arch in MOE_ARCHS:
        cfg, jcfg = _cfgs(arch)
        for cf in (0.5, 1.25, 8.0):
            c, jc = (dataclasses.replace(x, capacity_factor=cf)
                     for x in (cfg, jcfg))
            assert moe.capacity(n_tokens, c) == jax_moe.capacity(n_tokens,
                                                                 jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_route_matches_jax_exactly(arch, cf):
    """``_route`` over 64 tokens: expert choices, slot positions and kept
    flags equal; gates and probabilities within 1e-4.  At capacity factor
    0.5 choices are dropped."""
    cfg, jcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _ffn(jcfg)
    xt = np.random.RandomState(1).randn(64, cfg.d_model).astype(np.float32)
    C = moe.capacity(64, cfg)
    jr = jax_moe._route(jnp.asarray(xt), jp["router"], jcfg, C)
    r = moe._route(torch.from_numpy(xt), tp["router"], cfg, C)
    names = ("gates", "expert_idx", "flat_e", "pos_c", "keep", "probs")
    for name, got, want in zip(names, r, jr):
        want = np.asarray(want)
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got.numpy().astype(want.dtype),
                                          want, err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, err_msg=name,
                                       **TOL)
    keep = r[4].numpy()
    assert keep.all() if cf == 1.25 else not keep.all()


def test_route_ties_pick_the_lower_expert_as_jax():
    """Equal router probabilities (a zero token gives a uniform softmax):
    the lowest experts first, as ``jax.lax.top_k`` picks them."""
    cfg, jcfg = _cfgs("phi3.5-moe-42b-a6.6b")
    jp, tp = _ffn(jcfg)
    xt = np.zeros((3, cfg.d_model), np.float32)
    jr = jax_moe._route(jnp.asarray(xt), jp["router"], jcfg, 8)
    r = moe._route(torch.from_numpy(xt), tp["router"], cfg, 8)
    np.testing.assert_array_equal(r[1].numpy(), np.asarray(jr[1]))
    np.testing.assert_array_equal(r[1].numpy(), [[0, 1]] * 3)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_dense_matches_jax(arch, cf):
    """``_moe_dense`` (and ``moe_ffn``, which runs it without a mesh) over
    2 x 24 tokens: output and auxiliary loss."""
    cfg, jcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _ffn(jcfg)
    x = np.random.RandomState(2).randn(2, 24, cfg.d_model).astype(np.float32)
    jy, jaux = jax_moe.moe_ffn(jp, jnp.asarray(x), jcfg, jnp.float32)
    y, aux = moe.moe_ffn(tp, torch.from_numpy(x), cfg, F32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_init_moe_router_is_float32():
    """The router is made in float32 whatever the parameters' type, the
    experts in it, as the reference makes them."""
    cfg = get_config("mixtral-8x7b").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    jp = jax_moe.init_moe(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    assert p["router"].dtype == F32 and jp["router"].dtype == jnp.float32
    for k in ("w_gate", "w_up", "w_down"):
        assert p[k].dtype == torch.bfloat16 and p[k].shape == jp[k].shape


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_jax(arch):
    """6 teacher-forced decode steps of 2 rows: logits and caches."""
    cfg, jcfg = _cfgs(arch)
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    tokens = np.random.RandomState(3).randint(0, 256, (6, 2)).astype(
        np.int32)
    cache = lm.init_cache(cfg, 2, 8, F32, device="cpu")
    jcache = jax_lm.init_cache(jcfg, 2, 8, jnp.float32)
    step = jax.jit(functools.partial(jax_tf.decode_step, jcfg,
                                     compute_dtype=jnp.float32))
    for pos, tok in enumerate(tokens):
        jl, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = transformer.decode_step(cfg, params, cache,
                                            torch.from_numpy(tok), pos, F32)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
        got, want = cache_to_numpy(cfg, cache), _np_tree(jcache)
        for k in ("k", "v"):
            np.testing.assert_allclose(got["b0"][k], want["b0"][k], **TOL)


def test_server_keeps_the_router_in_float32():
    """A bf16 server casts the experts and keeps the router as given."""
    cfg = get_config("mixtral-8x7b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    srv = serve.BatchedLMServer(cfg, params, batch_slots=2, max_seq=8,
                                compute_dtype=torch.bfloat16, device="cpu")
    ffn = srv.params.blocks[0].ffn
    assert ffn["router"].dtype == F32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert srv.params.embed.dtype == torch.bfloat16


def _drain(server, prompts, max_new):
    pending = list(prompts)
    steps = 0
    while pending or server.active:
        while pending and server.submit(*pending[0], max_new):
            pending.pop(0)
        server.step()
        steps += 1
    return steps


def test_batched_server_matches_jax_mixtral():
    """mixtral (reduced: SWA window 32, so the 4-slot server's rolling
    cache wraps): 10 requests of 6 prompt tokens and 10 new ones over 4
    slots, identical completions, in order."""
    cfg, jcfg = _cfgs("mixtral-8x7b")
    rng = np.random.RandomState(4)
    prompts = [(i, rng.randint(0, cfg.vocab_size, 6).tolist())
               for i in range(10)]
    jsrv = JaxServer(jcfg, _jax_params(jcfg), batch_slots=4, max_seq=64)
    srv = serve.BatchedLMServer(cfg, _port_params(cfg, jcfg), batch_slots=4,
                                max_seq=64, device="cpu")
    assert srv.cache[0]["k"].shape[1] == cfg.swa_window == 32
    steps = _drain(srv, prompts, 10)
    assert steps == _drain(jsrv, prompts, 10) and srv.pos > cfg.swa_window
    assert [(r["id"], r["out"]) for r in srv.completed] == [
        (r["id"], r["out"]) for r in jsrv.completed]
    assert len(srv.completed) == 10
