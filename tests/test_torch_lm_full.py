"""The port's full-sequence LM path and its attention variants against the
JAX package's: ``_sdpa_full``, ``_sdpa_chunked``, the prefill cache
(``return_kv``, the sliding-window roll, ``kv_pad_to``), sliding-window
decode on the rolling and the linear cache, the int8 cache, ``forward``
for all ten architectures, ``prefill`` then ``decode_step``, ``decode_step``
for the dense ones, and the loss.

Inputs are made with ``numpy.random.RandomState``; JAX parameters come from
``lm.init_params`` and cross with ``models.convert``.  The port runs on CPU
tensors, so ``decode_attention`` runs its plain version (the card holds the
kernel to it in ``chip_smoke.py``).  Everything runs in float32 at the
reduced configurations (``cfg.reduced()``), with a few tokens and a batch
of at most 2.

Tolerances: logits, attention outputs and float states at
``rtol=atol=1e-4`` (the two packages sum in other orders through a few
layers); int8 codes and scales, greedy tokens and parameter carry-over
exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import lm as jax_lm, transformer as jax_tf  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.models import attention, lm, transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_from_numpy, cache_to_numpy, params_from_numpy, params_to_numpy)

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32
DENSE = ["internlm2-20b", "minitron-4b", "olmo-1b", "qwen2-1.5b",
         "musicgen-medium", "llava-next-34b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **fields):
    """The reduced configuration of ``arch`` in the port and in the JAX
    package, equal field for field."""
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


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


def _assert_cache(got, want, what, exact=False):
    for b in want:
        for k in want[b]:
            if exact or want[b][k].dtype.kind == "i":
                np.testing.assert_array_equal(got[b][k], want[b][k],
                                              err_msg=f"{what} {b}/{k}")
            else:
                np.testing.assert_allclose(got[b][k], want[b][k],
                                           err_msg=f"{what} {b}/{k}", **TOL)


# -- attention ----------------------------------------------------------------

def _qkv(B, S, H, Hk, dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, dh).astype(np.float32),
            rng.randn(B, S, Hk, dh).astype(np.float32),
            rng.randn(B, S, Hk, dh).astype(np.float32))


ATTN_CASES = {"full": dict(), "swa": dict(attention="swa", swa_window=5)}


@pytest.mark.parametrize("variant", sorted(ATTN_CASES))
@pytest.mark.parametrize("path", ["full", "chunked"])
def test_sdpa_matches_jax(variant, path):
    """``_sdpa_full`` and ``_sdpa_chunked`` (chunks of 4 over 10 keys: the
    last one padded) against the reference's, causal and windowed, with
    GQA (4 query heads over 2 kv heads)."""
    cfg, jcfg = _cfgs("qwen2-1.5b", **ATTN_CASES[variant])
    q, k, v = _qkv(2, 10, 4, 2, 16, 3)
    positions = np.arange(10, dtype=np.int32)
    jpos = jnp.asarray(positions)
    tpos = torch.from_numpy(positions)
    if path == "full":
        want = jax_attn._sdpa_full(*map(jnp.asarray, (q, k, v)), jpos, jpos,
                                   jcfg)
        got = attention._sdpa_full(*map(torch.from_numpy, (q, k, v)), tpos,
                                   tpos, cfg)
    else:
        want = jax_attn._sdpa_chunked(*map(jnp.asarray, (q, k, v)), jpos,
                                      jpos, jcfg, chunk=4)
        got = attention._sdpa_chunked(*map(torch.from_numpy, (q, k, v)),
                                      tpos, tpos, cfg, chunk=4)
    assert got.shape == (2, 10, 4, 16) and got.dtype == F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _attn_params(cfg, jcfg):
    jparams = _jax_params(jcfg)["groups"]["b0"]["mixer"]
    jp = jax.tree.map(lambda a: a[0], jparams)
    return jp, {k: torch.from_numpy(np.array(a)) for k, a in
                _np_tree(jp).items()}


@pytest.mark.parametrize("S,window,pad", [(6, 8, 0),       # inside the window
                                          (8, 8, 0),       # exactly W
                                          (11, 8, 0),      # rolled by 3
                                          (11, 8, 14),     # rolled, padded
                                          (6, 8, 12)])     # linear, padded
def test_return_kv_matches_jax(S, window, pad):
    """The prefill cache of one attention layer: the last ``W`` positions
    rolled by ``S % W`` once ``S >= W``, padded to ``kv_pad_to``; and the
    layer's output, with the chunked path forced."""
    cfg, jcfg = _cfgs("mixtral-8x7b", swa_window=window)
    jp, tp = _attn_params(cfg, jcfg)
    x = np.random.RandomState(S + pad).randn(2, S, cfg.d_model).astype(
        np.float32)
    pos = np.arange(S, dtype=np.int32)
    jy, jc = jax_attn.attention(jp, jnp.asarray(x), jcfg,
                                positions=jnp.asarray(pos),
                                compute_dtype=jnp.float32, chunked=True,
                                return_kv=True, kv_pad_to=pad)
    y, c = attention.attention(tp, torch.from_numpy(x), cfg,
                               positions=torch.from_numpy(pos),
                               compute_dtype=F32, chunked=True,
                               return_kv=True, kv_pad_to=pad)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert set(c) == {"k", "v"}
    for n in ("k", "v"):
        assert c[n].shape == jc[n].shape
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)


def test_decode_attention_lower_bound_plain():
    """The plain version's lower bound equals the plain version over the
    rows from ``lo`` on at ``pos - lo``, at the edges: ``lo = 0``,
    ``lo = pos``, inside the first and the last 64-row tile, and past
    ``S``; and the wrapper refuses ``lo`` outside ``[0, min(pos, S-1)]``."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 6, 32).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 2, 300, 32).astype(np.float32))
            for _ in range(2))
    for pos, lo in [(200, 0), (200, 200), (200, 5), (299, 250), (400, 280)]:
        got = decode_attention(q, k, v, pos, lo)
        want = decode_attention_plain(q, k[:, :, lo:], v[:, :, lo:],
                                      pos - lo)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(decode_attention(q, k, v, 200, 0),
                               decode_attention(q, k, v, 200))
    for pos, lo in [(10, 11), (10, -1), (400, 300)]:
        with pytest.raises(ValueError, match="lo"):
            decode_attention(q, k, v, pos, lo)


def _teacher_force(cfg, jcfg, tokens, cache, jcache, start=0, exact=False):
    """Decode ``tokens`` (steps, B) from position ``start`` in both
    packages on the given caches, comparing logits and the whole cache
    after every step."""
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    step = jax.jit(functools.partial(jax_tf.decode_step, jcfg,
                                     compute_dtype=jnp.float32))
    for i, tok in enumerate(tokens):
        pos = start + i
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok),
                               jnp.int32(pos))
        logits, cache = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(tok), pos, F32)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"pos {pos}", **TOL)
        _assert_cache(cache_to_numpy(cfg, cache), _np_tree(jcache),
                      f"pos {pos}", exact)
    return cache, jcache


def test_swa_rolling_decode_past_the_window_matches_jax():
    """A rolling cache of W = 6 slots (``init_cache`` caps ``max_seq``),
    decoded 14 steps: slots are reused from position 6 on."""
    cfg, jcfg = _cfgs("mixtral-8x7b", swa_window=6)
    tokens = _tokens(cfg, (14, 2), 5)
    cache = lm.init_cache(cfg, 2, 32, F32, device="cpu")
    assert cache[0]["k"].shape[1] == 6
    _teacher_force(cfg, jcfg, tokens, cache,
                   jax_lm.init_cache(jcfg, 2, 32, jnp.float32))


@pytest.mark.parametrize("S0", [3, 6])
def test_swa_linear_decode_matches_jax(S0):
    """A linear cache (``kv_pad_to`` = 16 rows past W = 4) from a prefill of
    3 tokens (inside the window) or 6 (rolled, then padded: the reference's
    layout, kept), decoded 8 steps: the kernel's lower bound
    ``pos - W + 1``."""
    cfg, jcfg = _cfgs("mixtral-8x7b", swa_window=4, capacity_factor=8.0)
    tokens = _tokens(cfg, (2, S0 + 8), 6)
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    jl, jcache = jax_tf.prefill(jcfg, jparams,
                                tokens=jnp.asarray(tokens[:, :S0]),
                                compute_dtype=jnp.float32, kv_pad_to=16)
    lg, cache = transformer.prefill(cfg, params,
                                    tokens=torch.from_numpy(tokens[:, :S0]),
                                    compute_dtype=F32, kv_pad_to=16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert cache[0]["k"].shape[1] == 16
    _teacher_force(cfg, jcfg, tokens[:, S0:].T.copy(), cache, jcache,
                   start=S0)


def test_int8_codes_and_scales_exact():
    """``_quantize_kv``: codes and float16 scales equal the reference's bit
    for bit, ties at .5 rounded to even (rows scaled so that the largest
    magnitude is 127: the scale is exactly 1), and the dequantized values
    within float32 rounding."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 2, 16).astype(np.float32)
    x[0, 0, 0] = [127, 2.5, -2.5, 3.5, -0.5, 0.5, 1.5, 126.5] * 2
    jq, js = jax_attn._quantize_kv(jnp.asarray(x))
    q, s = attention._quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert list(q[0, 0, 0, :8]) == [127, 2, -2, 4, 0, 0, 2, 126]
    np.testing.assert_allclose(
        attention._dequantize_kv(q, s, F32).numpy(),
        np.asarray(jax_attn._dequantize_kv(jq, js, jnp.float32)),
        rtol=1e-7, atol=0)


def test_int8_cache_decode_matches_jax():
    """qwen2 with an int8 cache, 10 teacher-forced steps: logits within
    1e-4, codes and scales equal after every step."""
    cfg, jcfg = _cfgs("qwen2-1.5b")
    tokens = _tokens(cfg, (10, 2), 8)
    cache = lm.init_cache(cfg, 2, 16, torch.int8, device="cpu")
    assert cache[0]["k"].dtype == torch.int8
    assert cache[0]["k_scale"].dtype == torch.float16
    _teacher_force(cfg, jcfg, tokens, cache,
                   jax_lm.init_cache(jcfg, 2, 16, jnp.int8))


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_forward_matches_jax(arch):
    """Logits and the MoE auxiliary loss of the full-sequence forward, 2 x 7
    tokens; llava-next through precomputed ``embeds`` (its vision tower is
    a stub), the rest through tokens."""
    cfg, jcfg = _cfgs(arch)
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    if cfg.modality == "vlm_stub":
        x = np.random.RandomState(9).randn(2, 7, cfg.d_model).astype(
            np.float32) * 0.1
        kw, jkw = (dict(embeds=torch.from_numpy(x)),
                   dict(embeds=jnp.asarray(x)))
    else:
        t = _tokens(cfg, (2, 7), 9)
        kw, jkw = (dict(tokens=torch.from_numpy(t)),
                   dict(tokens=jnp.asarray(t)))
    jlogits, jaux = jax_tf.forward(jcfg, jparams, compute_dtype=jnp.float32,
                                   **jkw)
    logits, aux = transformer.forward(cfg, params, compute_dtype=F32, **kw)
    assert logits.shape == (2, 7, cfg.vocab_size) and logits.dtype == F32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if cfg.n_experts:
        assert float(aux) > 0


def test_forward_past_the_chunk_threshold_matches_jax():
    """4 100 tokens, above ``CHUNK_THRESHOLD``: both packages take the
    chunked path (five 1 024-key chunks, the last padded)."""
    cfg, jcfg = _cfgs("qwen2-1.5b")
    S = attention.CHUNK_THRESHOLD + 4
    assert S > jax_attn.CHUNK_THRESHOLD == attention.CHUNK_THRESHOLD
    t = _tokens(cfg, (1, S), 10)
    jlogits, _ = jax.jit(functools.partial(
        jax_tf.forward, jcfg, compute_dtype=jnp.float32))(
        _jax_params(jcfg), tokens=jnp.asarray(t))
    logits, _ = transformer.forward(cfg, _port_params(cfg, jcfg),
                                    tokens=torch.from_numpy(t),
                                    compute_dtype=F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


CONTINUITY = ["qwen2-1.5b", "olmo-1b", "rwkv6-7b", "jamba-v0.1-52b",
              "mixtral-8x7b"]


@pytest.mark.parametrize("arch", CONTINUITY)
def test_prefill_then_decode_matches_jax(arch):
    """tests/test_prefill_decode_continuity.py's five architectures:
    prefill 6 tokens (padded to 12 rows), then decode 4, the last logits
    and every layer's cache compared after the prefill and every step."""
    fields = dict(capacity_factor=8.0) if "mixtral" in arch or \
        "jamba" in arch else {}
    cfg, jcfg = _cfgs(arch, **fields)
    tokens = _tokens(cfg, (1, 10), 11)
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    jl, jcache = jax_tf.prefill(jcfg, jparams,
                                tokens=jnp.asarray(tokens[:, :6]),
                                compute_dtype=jnp.float32, kv_pad_to=12)
    lg, cache = transformer.prefill(cfg, params,
                                    tokens=torch.from_numpy(tokens[:, :6]),
                                    compute_dtype=F32, kv_pad_to=12)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    _assert_cache(cache_to_numpy(cfg, cache), _np_tree(jcache), "prefill")
    _teacher_force(cfg, jcfg, tokens[:, 6:].T.copy(), cache, jcache,
                   start=6)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax(arch):
    """Single-token decode of the dense architectures, 6 teacher-forced
    steps of 2 rows, logits and caches after every step."""
    cfg, jcfg = _cfgs(arch)
    _teacher_force(cfg, jcfg, _tokens(cfg, (6, 2), 12),
                   lm.init_cache(cfg, 2, 8, F32, device="cpu"),
                   jax_lm.init_cache(jcfg, 2, 8, jnp.float32))


def test_make_prefill_matches_jax():
    cfg, jcfg = _cfgs("minitron-4b")
    t = _tokens(cfg, (2, 5), 13)
    want = jax_lm.make_prefill(jcfg, jnp.float32)(_jax_params(jcfg),
                                                  tokens=jnp.asarray(t))
    got = lm.make_prefill(cfg, F32)(_port_params(cfg, jcfg),
                                    tokens=torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_entropy_with_ignore_index_matches_jax():
    rng = np.random.RandomState(14)
    logits = (rng.randn(2, 6, 40) * 3).astype(np.float32)
    labels = rng.randint(0, 40, (2, 6)).astype(np.int32)
    labels[0, :2] = labels[1, 5] = lm.IGNORE_INDEX
    assert lm.IGNORE_INDEX == jax_lm.IGNORE_INDEX
    want = jax_lm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = lm.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_ignored = np.full((1, 3), lm.IGNORE_INDEX, np.int32)
    assert float(lm.cross_entropy(torch.from_numpy(logits[:1, :3]),
                                  torch.from_numpy(all_ignored))) == 0.0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_loss_fn_matches_jax(arch):
    """Cross-entropy plus ``MOE_AUX_COEF`` times the MoE loss, and both
    terms, with some labels ignored."""
    cfg, jcfg = _cfgs(arch)
    assert lm.MOE_AUX_COEF == jax_lm.MOE_AUX_COEF
    t = _tokens(cfg, (2, 6), 15)
    labels = np.roll(t, -1, axis=1)
    labels[:, -1] = lm.IGNORE_INDEX
    jloss, jm = jax_lm.loss_fn(jcfg, _jax_params(jcfg),
                               {"tokens": jnp.asarray(t),
                                "labels": jnp.asarray(labels)},
                               compute_dtype=jnp.float32)
    loss, m = lm.loss_fn(cfg, _port_params(cfg, jcfg),
                         {"tokens": torch.from_numpy(t),
                          "labels": torch.from_numpy(labels)},
                         compute_dtype=F32)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for k in ("ce_loss", "moe_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL)


# -- carry-over ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-7b",
                                  "jamba-v0.1-52b", "qwen2-1.5b"])
def test_params_round_trip_exact_every_family(arch):
    """MoE (stacked experts, float32 router), RWKV-6 (no ffn), the hybrid
    group, and a dense block: the reference's tree, back unchanged."""
    cfg, jcfg = _cfgs(arch)
    tree = _np_tree(_jax_params(jcfg))
    back = params_to_numpy(cfg, params_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,dtype", [("qwen2-1.5b", "int8"),
                                        ("rwkv6-7b", "float32"),
                                        ("jamba-v0.1-52b", "float32"),
                                        ("mixtral-8x7b", "float32")])
def test_cache_round_trip_exact_every_family(arch, dtype):
    """``{k, v, k_scale, v_scale}`` (int8 codes, float16 scales), ``{wkv,
    tm_shift, cm_shift}``, Jamba's ``{h, conv}`` with one ``{k, v}`` a
    group, and the rolling SWA cache: random contents, back unchanged."""
    cfg, jcfg = _cfgs(arch)
    rng = np.random.RandomState(16)
    jcache = _np_tree(jax_lm.init_cache(jcfg, 2, 8, getattr(jnp, dtype)))

    def fill(a):
        if a.dtype.kind == "i":
            return rng.randint(-127, 128, a.shape).astype(a.dtype)
        return rng.randn(*a.shape).astype(a.dtype)

    tree = jax.tree.map(fill, jcache)
    port = cache_from_numpy(cfg, tree, device="cpu")
    fresh = lm.init_cache(cfg, 2, 8, getattr(torch, dtype), device="cpu")
    assert [{k: (t.shape, t.dtype) for k, t in c.items()} for c in port] \
        == [{k: (t.shape, t.dtype) for k, t in c.items()} for c in fresh]
    back = cache_to_numpy(cfg, port)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
