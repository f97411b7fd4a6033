"""The port's LM serving path against the JAX package's.

Inputs are made with ``numpy.random.RandomState``; JAX parameters come from
``lm.init_params`` and cross with ``models.convert``.  The port runs on CPU
tensors, so ``decode_attention`` runs its plain version (the Hopper kernel
is held against that plain version on the card, in ``test_torch_cuda.py``
and ``chip_smoke.py``); the JAX kernel runs in interpret mode, as
``tests/test_kernels.py`` runs it.  Each JAX function is jit-compiled once
per configuration.

Tolerances: the kernel at ``rtol=atol=2e-5``, as ``test_kernels.py`` holds
the Pallas kernel to its oracle in float32 (the port sums in another
order), in bf16 too, since both sides widen the same bf16 inputs to
float32 and sum in float32; decode logits at ``rtol=atol=2e-4``, as
``test_arch_smoke.py::test_decode_matches_forward_prefix`` holds decode to
the forward pass; caches at ``1e-5`` (k and v pass through one projection
and RoPE); greedy tokens and parameter carry-over exactly.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.launch.serve import BatchedLMServer as JaxServer  # noqa: E402
from repro.models import lm as jax_lm, transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attn  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention, kernel_config, split_plan)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_from_numpy, cache_to_numpy, params_from_numpy, params_to_numpy)

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **widths):
    """The reduced configuration of ``arch`` in the port and in the JAX
    package (two copies of one dataclass), equal field for field."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **widths)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **widths)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg, jcfg


@functools.cache
def _jax_params(jcfg, seed=0):
    return jax_lm.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)


def _port_params(cfg, jcfg, seed=0):
    return params_from_numpy(cfg, _np_tree(_jax_params(jcfg, seed)),
                             device="cpu")


@functools.cache
def _jax_decode(jcfg):
    return jax.jit(lambda p, c, t, pos: jax_tf.decode_step(
        jcfg, p, c, t, pos, jnp.float32))


# -- the kernel ---------------------------------------------------------------

def _qkv(b, h, hk, s, dh, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, dh).astype(np.float32),
            rng.randn(b, hk, s, dh).astype(np.float32),
            rng.randn(b, hk, s, dh).astype(np.float32))


def _port_attn(q, k, v, pos, dtype=torch.float32):
    return decode_attention(*(torch.from_numpy(a).to(dtype)
                              for a in (q, k, v)), pos).numpy()


@pytest.mark.parametrize("b,h,hk,s,dh", [(1, 2, 2, 512, 64),
                                         (2, 4, 2, 1024, 128),
                                         (1, 8, 2, 1024, 64),
                                         (1, 6, 1, 2048, 128)])
def test_decode_attention_matches_jax(b, h, hk, s, dh):
    """test_kernels.py::test_decode_attention_matches_ref's shapes."""
    q, k, v = _qkv(b, h, hk, s, dh, b * h + s)
    got = _port_attn(q, k, v, s - 7)
    assert got.shape == (b, h, dh) and got.dtype == np.float32
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(jq, jk, jv, jnp.int32(s - 7))),
        **KERNEL_TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref.decode_attention_ref(jq, jk, jv, s - 7)),
        **KERNEL_TOL)


def test_decode_attention_bf16_matches_ref():
    q, k, v = _qkv(1, 4, 2, 1024, 64, 3)
    got = _port_attn(q, k, v, 700, torch.bfloat16)
    want = ref.decode_attention_ref(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), 700)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **KERNEL_TOL)


@pytest.mark.parametrize("s,pos", [(512, 0),        # one position
                                   (512, 600),      # pos >= S: all of S
                                   (1000, 993),     # ragged S
                                   (1000, 2000)])
def test_decode_attention_edges_match_ref(s, pos):
    """Against the oracle only: the JAX kernel asserts S % 512 == 0."""
    q, k, v = _qkv(2, 6, 2, s, 32, s + pos)
    want = ref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    pos)
    np.testing.assert_allclose(_port_attn(q, k, v, pos), np.asarray(want),
                               **KERNEL_TOL)


def test_decode_attention_reads_seq_major_view():
    """The model's (B, S, Hk, dh) cache, permuted, gives what a contiguous
    head-major copy gives."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 6, 32).astype(np.float32))
    cache_k = torch.from_numpy(rng.randn(2, 96, 2, 32).astype(np.float32))
    cache_v = torch.from_numpy(rng.randn(2, 96, 2, 32).astype(np.float32))
    view_k, view_v = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    assert not view_k.is_contiguous()
    got = decode_attention(q, view_k, view_v, 50)
    want = decode_attention(q, view_k.contiguous(), view_v.contiguous(), 50)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_decode_attention_rejects_bad_inputs():
    q, k = torch.zeros(1, 4, 16), torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="pos"):
        decode_attention(q, k, k, -1)
    with pytest.raises(TypeError):
        decode_attention(q, k.double(), k.double(), 3)
    with pytest.raises(ValueError):
        decode_attention(q, torch.zeros(1, 3, 8, 16), k, 3)
    with pytest.raises(ValueError):               # neither cpu nor cuda
        decode_attention(q.to("meta"), k.to("meta"), k.to("meta"), 3)
    before = decode_attention.launches
    decode_attention(q, k, k, 3)
    assert decode_attention.launches == before    # CPU tensors launch nothing


@pytest.mark.parametrize("B,H,Hk,n_valid", [(8, 12, 2, 1), (8, 12, 2, 512),
                                            (8, 12, 2, 1024),
                                            (128, 12, 2, 32768),
                                            (1, 16, 1, 1000),
                                            (1, 24, 8, 77)])
def test_split_plan_covers_positions(B, H, Hk, n_valid):
    """The kernel's splits cover [0, n_valid) with none empty, at least 64
    positions each unless one split holds all."""
    cfg = kernel_config(torch.float32, 128)
    splits, chunk = split_plan(B, H, Hk, n_valid, 132, cfg)
    assert splits >= 1 and chunk * (splits - 1) < n_valid <= chunk * splits
    assert splits == 1 or chunk >= 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n_valid", [1, 31, 32, 33, 63, 64, 65, 95, 96, 97,
                                     191, 192, 193, 1000, 1024, 32768])
def test_split_plan_covers_each_position_once(dtype, n_valid):
    """Splits [i * chunk, min((i + 1) * chunk, n_valid)) partition the
    positions: each covered exactly once, every split non-empty and whole
    stages but the last (around one tile, one stage and one ring of each
    type)."""
    cfg = kernel_config(getattr(torch, dtype), 128)
    for B, H, Hk in [(8, 12, 2), (1, 56, 8), (128, 12, 2), (1, 16, 16)]:
        splits, chunk = split_plan(B, H, Hk, n_valid, 132, cfg)
        assert splits == 1 or chunk % cfg.tile == 0
        seen = np.zeros(n_valid, np.int64)
        for i in range(splits):
            lo, hi = i * chunk, min((i + 1) * chunk, n_valid)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dh", [8, 16, 64, 96, 128, 256])
def test_kernel_config_fits_shared_memory(dtype, dh):
    """A block's shared memory stays within the 227 KB a block may have,
    with at least two stages, and the ring can hold the warps' merge."""
    cfg = kernel_config(getattr(torch, dtype), dh)
    es = 4 if dtype == "float32" else 2
    assert 2 <= cfg.stages <= decode_attn.MAX_STAGES
    assert cfg.smem_bytes <= decode_attn.SMEM_PER_BLOCK
    assert cfg.blocks_per_sm >= 1
    assert cfg.blocks_per_sm * (cfg.smem_bytes
                                + decode_attn.SMEM_RESERVED_PER_BLOCK) \
        <= decode_attn.SMEM_PER_SM
    ring = cfg.stages * 2 * cfg.tile * dh * es
    assert ring >= (decode_attn.CONSUMER_WARPS * decode_attn.ROWS_PER_BLOCK
                    * dh * 4)
    assert cfg.blocks_per_sm <= (2 if dh <= 128 else 1)   # launch bounds


@pytest.mark.parametrize("shape", ["decode_32k", "serve"])
def test_split_plan_fills_whole_waves(shape):
    """decode_32k (bf16) and the serve shape (f32) fill the 132 SMs with no
    ragged last wave: with k blocks on the busiest SM, the grid holds at
    least 90 % of k blocks on every SM, and k never exceeds what an SM
    holds at once."""
    B, H, Hk, n_valid, dtype = {
        "decode_32k": (128, 12, 2, 32768, torch.bfloat16),
        "serve": (8, 12, 2, 1024, torch.float32)}[shape]
    cfg = kernel_config(dtype, 128)
    splits, _ = split_plan(B, H, Hk, n_valid, 132, cfg)
    blocks = B * Hk * -(-(H // Hk) // decode_attn.ROWS_PER_BLOCK) * splits
    per_sm = -(-blocks // 132)
    assert per_sm <= cfg.blocks_per_sm, (splits, blocks)
    assert blocks >= 0.9 * per_sm * 132, (splits, blocks)


# -- the model ----------------------------------------------------------------

DECODE_ARCHS = ["qwen2-1.5b", "olmo-1b", "minitron-4b"]


def _teacher_force(arch, tokens, max_seq):
    """Decode ``tokens`` (steps, B) in both packages from the same weights,
    comparing logits and the whole cache after every step."""
    cfg, jcfg = _cfgs(arch)
    steps, B = tokens.shape
    jparams = _jax_params(jcfg)
    params = _port_params(cfg, jcfg)
    jcache = jax_lm.init_cache(jcfg, B, max_seq, jnp.float32)
    cache = lm.init_cache(cfg, B, max_seq, torch.float32, device="cpu")
    step = _jax_decode(jcfg)
    for pos in range(steps):
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tokens[pos]),
                               jnp.int32(pos))
        logits, cache = transformer.decode_step(
            cfg, params, cache, torch.from_numpy(tokens[pos]), pos,
            torch.float32)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"pos {pos}", **LOGIT_TOL)
        want = _np_tree(jcache)
        got = cache_to_numpy(cfg, cache)
        for b in want:
            for k in want[b]:
                np.testing.assert_allclose(got[b][k], want[b][k],
                                           err_msg=f"pos {pos} {b}/{k}",
                                           **CACHE_TOL)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_matches_jax(arch):
    """qwen2: QKV bias, RMSNorm, tied embeddings; olmo: non-parametric LN;
    minitron: LayerNorm, untied head.  8 teacher-forced tokens."""
    tokens = np.random.RandomState(7).randint(0, 256, (8, 3)).astype(
        np.int32)
    _teacher_force(arch, tokens, max_seq=16)


def test_decode_past_max_seq_clamps_as_jax():
    """dynamic_update_slice clamps the write at pos >= S_max to the last
    row, and every row is then attended (attention.py:232-235)."""
    tokens = np.random.RandomState(8).randint(0, 256, (7, 2)).astype(
        np.int32)
    _teacher_force("qwen2-1.5b", tokens, max_seq=4)


def test_batched_server_matches_jax():
    """examples/serve_lm.py's workload: 8 slots, 24 requests of 8 prompt
    tokens and 24 new ones; identical completions, in order."""
    cfg, jcfg = _cfgs("qwen2-1.5b")
    n_req, max_new, slots = 24, 24, 8
    max_seq = 8 + max_new + n_req * 6 + 16
    rng = np.random.RandomState(0)
    prompts = [(i, rng.randint(0, cfg.vocab_size, 8).tolist())
               for i in range(n_req)]

    def drain(server):
        pending = list(prompts)
        steps = 0
        while pending or server.active:
            while pending and server.submit(*pending[0], max_new):
                pending.pop(0)
            server.step()
            steps += 1
        return steps

    jsrv = JaxServer(jcfg, _jax_params(jcfg), batch_slots=slots,
                     max_seq=max_seq)
    srv = serve.BatchedLMServer(cfg, _port_params(cfg, jcfg),
                                batch_slots=slots,
                                max_seq=max_seq, device="cpu")
    assert drain(srv) == drain(jsrv) == 93
    assert srv.host_reads == 93
    assert [(r["id"], r["out"]) for r in srv.completed] == [
        (r["id"], r["out"]) for r in jsrv.completed]
    assert all(len(r["out"]) == max_new for r in srv.completed)
    assert len(srv.completed) == n_req and srv.pos == jsrv.pos


# -- carry-over and init ------------------------------------------------------

@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_params_round_trip_exact(arch):
    cfg, jcfg = _cfgs(arch)
    tree = _np_tree(_jax_params(jcfg))
    back = params_to_numpy(cfg, params_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_cache_round_trip_exact():
    cfg, jcfg = _cfgs("minitron-4b")
    rng = np.random.RandomState(2)
    jcache = _np_tree(jax_lm.init_cache(jcfg, 2, 8, jnp.float32))
    tree = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype),
                        jcache)
    back = cache_to_numpy(cfg, cache_from_numpy(cfg, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_init_params_has_reference_tree_and_scales(arch):
    """Names, shapes and dtypes as the reference's; each random leaf's std
    within 5 % of the reference's (widths raised so that every leaf holds
    at least 16 384 draws: sampling error about 1 %)."""
    cfg, jcfg = _cfgs(arch, d_model=256, d_ff=512, vocab_size=1024,
                      n_heads=8, head_dim=32)
    want = _np_tree(jax_lm.init_params(jcfg, jax.random.PRNGKey(3),
                                       jnp.float32))
    got = params_to_numpy(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(3), torch.float32, device="cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if w.std() == 0:            # norms and biases: ones and zeros
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert abs(g.std() / w.std() - 1) < 0.05, name


# -- the production meshes need their world ----------------------------------

@pytest.mark.parametrize("mesh,ranks", [("16x16", 256), ("2x16x16", 512)])
def test_train_production_mesh_needs_its_ranks(mesh, ranks):
    """``--mesh 16x16`` (or ``2x16x16``) joins a world launched from
    outside; in a smaller one (here: this process alone) it raises, naming
    the ranks it needs, as the reference names devices."""
    with pytest.raises(RuntimeError, match=f"needs {ranks} ranks"):
        train.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
                    "--mesh", mesh])


def test_server_needs_a_card_unless_told_cpu():
    """No CPU fallback: with no card (as here) and no device, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = get_config("qwen2-1.5b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.BatchedLMServer(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-1.5b", "--reduced"])


def test_serve_main_runs_on_cpu(capsys):
    done = serve.main(["--arch", "qwen2-1.5b", "--reduced", "--requests",
                       "3", "--max-new", "4", "--slots", "2", "--device",
                       "cpu"])
    assert len(done) == 3 and all(len(r["out"]) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
