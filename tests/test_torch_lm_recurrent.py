"""The port's recurrent mixers (``models/mamba.py``, ``models/rwkv6.py``,
``layers.chunked_time_scan``) and the families built on them (rwkv6-7b,
Jamba's hybrid groups) against the JAX package's.

Each mixer is held on its full-sequence output and final state, and on
single steps from a random state (outputs and every state tensor), at
``rtol=atol=1e-4`` in float32.  Inputs are made with
``numpy.random.RandomState``; parameters come from the JAX package's
``lm.init_params`` through ``models.convert``.
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
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm, mamba as jax_mamba  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro.models import transformer as jax_tf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, mamba, rwkv6, transformer  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_to_numpy, params_from_numpy)
from repro_torch.models.layers import chunked_time_scan  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


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


def _mixer(jcfg, block):
    """Block ``block``'s mixer parameters of group 0, perturbed away from
    their constant inits (decay, bonus, mixes) so that every term counts:
    the JAX tree and the port's tensors."""
    jp = jax.tree.map(lambda a: a[0],
                      _jax_params(jcfg)["groups"][block]["mixer"])
    rng = np.random.RandomState(5)
    jp = {k: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
          for k, a in _np_tree(jp).items()}
    return ({k: jnp.asarray(a) for k, a in jp.items()},
            {k: torch.from_numpy(a) for k, a in jp.items()})


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL)


def test_chunked_time_scan_matches_jax():
    """A carry and two outputs a step over 10 steps of a tuple of inputs;
    the chunk size does not change the result."""
    rng = np.random.RandomState(1)
    xs = (rng.randn(10, 3).astype(np.float32),
          rng.randn(10, 3).astype(np.float32))

    def jstep(c, x):
        c = c * 0.9 + x[0] * x[1]
        return c, (c.sum(), c * 2)

    def step(c, x):
        c = c * 0.9 + x[0] * x[1]
        return c, (c.sum(), c * 2)

    jc, (ja, jb) = jax_layers.chunked_time_scan(
        jstep, jnp.zeros(3), tuple(map(jnp.asarray, xs)), chunk=4)
    for chunk in (4, 256):
        c, (a, b) = chunked_time_scan(step, torch.zeros(3),
                                      tuple(map(torch.from_numpy, xs)),
                                      chunk=chunk)
        assert a.shape == (10,) and b.shape == (10, 3)
        for got, want in ((c, jc), (a, ja), (b, jb)):
            _close(got, want, "scan")


def test_mamba_full_sequence_matches_jax():
    """Jamba's Mamba mixer over 2 x 9 tokens: output and the final state
    (``h`` in float32, the conv's last ``Kc - 1`` inputs)."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    jp, tp = _mixer(jcfg, "b0")
    x = np.random.RandomState(2).randn(2, 9, cfg.d_model).astype(np.float32)
    jy, js = jax_mamba.mamba(jp, jnp.asarray(x), jcfg, jnp.float32,
                             return_state=True)
    y, s = mamba.mamba(tp, torch.from_numpy(x), cfg, F32, return_state=True)
    _close(y, jy, "y")
    assert s["h"].dtype == F32 and set(s) == {"h", "conv"}
    for k in s:
        _close(s[k], js[k], k)
    assert mamba.mamba(tp, torch.from_numpy(x), cfg, F32)[1] is None


def test_mamba_steps_match_jax():
    """5 single steps from a random state: output, ``h`` and ``conv``
    after each, the port's cache updated in place."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    jp, tp = _mixer(jcfg, "b1")
    rng = np.random.RandomState(3)
    init = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                        _np_tree(jax_mamba.init_mamba_cache(jcfg, 2,
                                                            jnp.float32)))
    jc = {k: jnp.asarray(a) for k, a in init.items()}
    c = {k: torch.from_numpy(a.copy()) for k, a in init.items()}
    h_buf = c["h"]
    for t in range(5):
        x = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        jy, jc = jax_mamba.mamba(jp, jnp.asarray(x), jcfg, jnp.float32,
                                 cache=jc)
        y, c = mamba.mamba(tp, torch.from_numpy(x), cfg, F32, cache=c)
        _close(y, jy, f"y {t}")
        for k in c:
            _close(c[k], jc[k], f"{k} {t}")
    assert c["h"] is h_buf


def test_rwkv6_time_and_channel_mix_match_jax():
    """RWKV-6's time mix over 2 x 8 tokens from random wkv and shift
    states (output, new wkv state, new shift), then one step from there,
    and the channel mix over both."""
    cfg, jcfg = _cfgs("rwkv6-7b")
    jp, tp = _mixer(jcfg, "b0")
    rng = np.random.RandomState(4)
    H, dh = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    wkv = rng.randn(2, H, dh, dh).astype(np.float32)
    shift = rng.randn(2, cfg.d_model).astype(np.float32)
    for S in (8, 1):
        x = rng.randn(2, S, cfg.d_model).astype(np.float32)
        jy, jwkv, jsh = jax_rwkv.time_mix(jp, jnp.asarray(x), jcfg,
                                          jnp.float32, state=jnp.asarray(wkv),
                                          shift_state=jnp.asarray(shift))
        y, twkv, tsh = rwkv6.time_mix(tp, torch.from_numpy(x), cfg, F32,
                                      state=torch.from_numpy(wkv),
                                      shift_state=torch.from_numpy(shift))
        for got, want, what in ((y, jy, "y"), (twkv, jwkv, "wkv"),
                                (tsh, jsh, "shift")):
            _close(got, want, f"{what} S={S}")
        jy2, jsh2 = jax_rwkv.channel_mix(jp, jnp.asarray(x), jcfg,
                                         jnp.float32,
                                         shift_state=jnp.asarray(shift))
        y2, sh2 = rwkv6.channel_mix(tp, torch.from_numpy(x), cfg, F32,
                                    shift_state=torch.from_numpy(shift))
        _close(y2, jy2, f"channel S={S}")
        _close(sh2, jsh2, f"channel shift S={S}")
        wkv, shift = np.array(jwkv), np.array(jsh)
    # no state given: zeros, as the reference starts a prefill
    x = rng.randn(1, 4, cfg.d_model).astype(np.float32)
    jy = jax_rwkv.time_mix(jp, jnp.asarray(x), jcfg, jnp.float32)[0]
    _close(rwkv6.time_mix(tp, torch.from_numpy(x), cfg, F32)[0], jy,
           "from zeros")


def test_rwkv6_constants_and_cache_layout():
    assert (rwkv6.LORA_DIM, rwkv6.DECAY_LORA) == (jax_rwkv.LORA_DIM,
                                                  jax_rwkv.DECAY_LORA)
    cfg, jcfg = _cfgs("rwkv6-7b")
    got = rwkv6.init_rwkv_cache(cfg, 3, torch.bfloat16, "cpu")
    want = jax_rwkv.init_rwkv_cache(jcfg, 3, jnp.bfloat16)
    assert {k: (tuple(t.shape), str(t.dtype)[6:]) for k, t in got.items()} \
        == {k: (a.shape, str(a.dtype)) for k, a in want.items()}


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_decode_step_matches_jax(arch):
    """6 teacher-forced decode steps of 2 rows from empty caches: logits
    and every layer's state after every step (Jamba: 7 Mamba layers and
    the attention layer at index 4 of the group; 4 of them MoE)."""
    cfg, jcfg = _cfgs(arch)
    if arch.startswith("jamba"):
        assert cfg.layer_kinds()[4] == "attn" and \
            cfg.layer_kinds().count("mamba") == 7
        assert cfg.ffn_kinds().count("moe") == 4
    params, jparams = _port_params(cfg, jcfg), _jax_params(jcfg)
    tokens = np.random.RandomState(6).randint(0, 256, (6, 2)).astype(
        np.int32)
    cache = lm.init_cache(cfg, 2, 8, F32, device="cpu")
    jcache = jax_lm.init_cache(jcfg, 2, 8, jnp.float32)
    step = jax.jit(functools.partial(jax_tf.decode_step, jcfg,
                                     compute_dtype=jnp.float32))
    for pos, tok in enumerate(tokens):
        jl, jcache = step(jparams, jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = transformer.decode_step(cfg, params, cache,
                                            torch.from_numpy(tok), pos, F32)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   err_msg=f"pos {pos}", **TOL)
        got, want = cache_to_numpy(cfg, cache), _np_tree(jcache)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for b in want:
            for k in want[b]:
                np.testing.assert_allclose(got[b][k], want[b][k],
                                           err_msg=f"pos {pos} {b}/{k}",
                                           **TOL)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_prefill_state_owns_its_storage(arch):
    """F12: the recurrent state a prefill hands over (RWKV-6's shift
    states, Mamba's conv tail and state) holds no more than its own bytes,
    not a view that keeps a layer's whole (B, S, D) input alive."""
    cfg, jcfg = _cfgs(arch)
    tokens = torch.from_numpy(
        np.random.RandomState(7).randint(0, 256, (2, 24)).astype(np.int64))
    _, caches = transformer.prefill(cfg, _port_params(cfg, jcfg),
                                    tokens=tokens, compute_dtype=F32)
    assert len(caches) == cfg.n_layers
    states = [(l, k, t) for l, c in enumerate(caches)
              if transformer.layer_kinds(cfg, l)[0] != "attn"
              for k, t in c.items()]
    assert {k for _, k, _ in states} == (
        {"wkv", "tm_shift", "cm_shift"} if arch.startswith("rwkv")
        else {"h", "conv"})
    for l, k, t in states:
        assert t.untyped_storage().nbytes() == t.numel() * \
            t.element_size(), f"layer {l} {k}"


def test_rwkv6_block_has_no_ffn():
    cfg = get_config("rwkv6-7b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert params.blocks[0].subs == ("norm1", "mixer", "norm2")
    assert not hasattr(params.blocks[0], "ffn")


def test_server_keeps_float32_state_tensors():
    """A bf16 server casts the weights and keeps Mamba's ``A_log`` and
    ``D`` and RWKV-6's ``w0`` and ``u`` as given (float32); the recurrent
    states are float32 whatever the compute type."""
    for arch, names in (("jamba-v0.1-52b", ("A_log", "D")),
                        ("rwkv6-7b", ("w0", "u"))):
        cfg = get_config(arch).reduced()
        params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        srv = serve.BatchedLMServer(cfg, params, batch_slots=2, max_seq=8,
                                    compute_dtype=torch.bfloat16,
                                    device="cpu")
        mixer = srv.params.blocks[0].mixer
        assert all(mixer[n].dtype == F32 for n in names), arch
        state = "h" if arch.startswith("jamba") else "wkv"
        assert srv.cache[0][state].dtype == F32
        srv.submit(0, [1, 2, 3], 2)
        while srv.active:
            srv.step()
        assert len(srv.completed[0]["out"]) == 2


def test_batched_server_matches_jax_jamba():
    """Jamba (reduced: one group of 8 layers): 6 requests of 5 prompt
    tokens and 8 new ones over 4 slots, identical completions in order; a
    reused slot starts from the previous request's recurrent state in both
    packages."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    rng = np.random.RandomState(7)
    prompts = [(i, rng.randint(0, cfg.vocab_size, 5).tolist())
               for i in range(6)]

    def drain(server):
        pending = list(prompts)
        while pending or server.active:
            while pending and server.submit(*pending[0], 8):
                pending.pop(0)
            server.step()

    jsrv = JaxServer(jcfg, _jax_params(jcfg), batch_slots=4, max_seq=48)
    srv = serve.BatchedLMServer(cfg, _port_params(cfg, jcfg), batch_slots=4,
                                max_seq=48, device="cpu")
    drain(jsrv)
    drain(srv)
    assert srv.pos == jsrv.pos
    assert [(r["id"], r["out"]) for r in srv.completed] == [
        (r["id"], r["out"]) for r in jsrv.completed]


def test_serve_main_every_family_on_cpu(capsys):
    """The CLI's CPU rehearsal for an MoE, a hybrid and an SSM arch."""
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b", "rwkv6-7b"):
        done = serve.main(["--arch", arch, "--reduced", "--requests", "3",
                           "--max-new", "3", "--slots", "2", "--device",
                           "cpu"])
        assert len(done) == 3 and all(len(r["out"]) == 3 for r in done)
    assert capsys.readouterr().out.count("served 3 requests, 9 tokens") == 3
