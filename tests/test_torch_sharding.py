"""The port's sharding rules (``sharding/rules.py``) and constraints
(``sharding/constraints.py``) against the JAX package's.

The JAX rules run on ``jax.sharding.AbstractMesh`` meshes and
``jax.eval_shape`` trees at full width, so the production meshes need no
devices; the port's run on ``{axis: size}`` meshes and on meta-device
tensors.  For every leaf of all 10 configs, on the meshes (16, 16),
(2, 16, 16), (2, 2), (1, 4), (4, 1) and (8,), the port's spec equals the
reference's ``PartitionSpec`` and the port's local shard shape equals
``NamedSharding(...).shard_shape``; a block's tensor (and a layer's cache
entry) is the reference's without the stacked groups dim.  On (8,), a
mesh without ``"model"``, both packages' parameter rules raise
``KeyError``, and so do their cache rules where the batch shards (a
sequence-parallel cache drops the absent axis); ``batch_spec`` answers.
"""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.runtime.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.sharding import constraints as jax_constraints  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import constraints, rules  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "8": ((8,), ("data",))}
#: the decode cells' caches: decode_32k (batch 128) and long_500k (1)
CACHE_SHAPES = ("decode_32k", "long_500k")


def _meshes(name):
    shape, axes = MESHES[name]
    return dict(zip(axes, shape)), AbstractMesh(shape, axes)


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _flat(tree) -> dict:
    """``{"a/b/c": leaf}`` of a JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def _ref_name(cfg, name: str) -> tuple:
    """The reference's path of a port parameter and whether it carries the
    stacked groups dim."""
    parts = name.split(".")
    if parts[0] == "blocks":
        g = len(cfg.layer_kinds())
        return f"groups/b{int(parts[1]) % g}/{parts[2]}/{parts[3]}", True
    return "/".join(parts), False


@functools.cache
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(
        lambda: jax_lm.init_params(cfg, jax.random.PRNGKey(0), jnp.float32))


@functools.cache
def _port_params(arch):
    return lm.init_params(get_config(arch), torch.Generator(), torch.float32,
                          device="meta")


@functools.cache
def _jax_cache(arch, shape, dtype):
    cfg, spec = jax_get_config(arch), JSHAPES[shape]
    return jax.eval_shape(lambda: jax_lm.init_cache(
        cfg, spec.global_batch, spec.seq_len, getattr(jnp, dtype)))


@functools.cache
def _port_cache(arch, shape, dtype):
    spec = JSHAPES[shape]
    return lm.init_cache(get_config(arch), spec.global_batch, spec.seq_len,
                         getattr(torch, dtype), device="meta")


def _check_leaf(ms, amesh, name, spec, shape, jsharding, jshape, stacked):
    jspec = _pad(jsharding.spec, len(jshape))
    jlocal = jsharding.shard_shape(tuple(jshape))
    if stacked:
        assert jspec[0] is None and jshape[0] == jlocal[0], name
        jspec, jshape, jlocal = jspec[1:], jshape[1:], jlocal[1:]
    assert tuple(shape) == tuple(jshape), name
    assert spec == jspec, (name, spec, jspec)
    assert rules.local_shape(ms, spec, shape) == tuple(jlocal), name


def _raises_like_jax(fn_port, fn_jax):
    with pytest.raises(KeyError) as port:
        fn_port()
    with pytest.raises(KeyError) as ref:
        fn_jax()
    assert port.value.args == ref.value.args == ("model",)


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, mesh, fsdp):
    ms, amesh = _meshes(mesh)
    cfg, params = get_config(arch), _port_params(arch)
    jparams = _jax_params(arch)
    if "model" not in ms:
        _raises_like_jax(
            lambda: rules.param_sharding(ms, params, fsdp=fsdp),
            lambda: jax_rules.param_sharding(amesh, jparams, fsdp=fsdp))
        return
    got = rules.param_sharding(ms, params, fsdp=fsdp)
    want = _flat(jax_rules.param_sharding(amesh, jparams, fsdp=fsdp))
    shapes = _flat(jparams)
    named = dict(params.named_parameters())
    assert len(got) == len(named)
    for name, spec in got.items():
        ref, stacked = _ref_name(cfg, name)
        _check_leaf(ms, amesh, name, spec, named[name].shape, want[ref],
                    shapes[ref].shape, stacked)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_equal_jax(arch, mesh):
    """The train state: the moments mirror the parameters; ``count`` and
    ``step`` are replicated."""
    ms, amesh = _meshes(mesh)
    cfg = get_config(arch)
    state, _ = train.make_trainer(cfg, steps=10, device="meta")
    jparams = _jax_params(arch)
    jstate = {"params": jparams, "opt": jax.eval_shape(JaxAdamW().init,
                                                       jparams),
              "step": jax.ShapeDtypeStruct((), jnp.int32)}
    if "model" not in ms:
        _raises_like_jax(lambda: rules.state_sharding(ms, state),
                         lambda: jax_rules.state_sharding(amesh, jstate))
        return
    got = rules.state_sharding(ms, state)
    want = _flat(jax_rules.state_sharding(amesh, jstate))
    shapes = _flat(jstate)
    assert got["step"] == () and _pad(want["step"].spec, 0) == ()
    assert got["opt"]["count"] == () and \
        _pad(want["opt/count"].spec, 0) == ()
    named = dict(state["params"].named_parameters())
    for part, tree in (("params", got["params"]),
                       ("opt/mu", got["opt"]["mu"]),
                       ("opt/nu", got["opt"]["nu"])):
        assert len(tree) == len(named)
        for name, spec in tree.items():
            ref, stacked = _ref_name(cfg, name)
            ref = f"{part}/{ref}"
            _check_leaf(ms, amesh, name, spec, named[name].shape, want[ref],
                        shapes[ref].shape, stacked)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_jax(arch, mesh, dtype):
    """The decode cells' caches (batch 128 at 32k, and batch 1 at 512k:
    the sequence-parallel fallback), bfloat16 and int8."""
    ms, amesh = _meshes(mesh)
    cfg = get_config(arch)
    g = len(cfg.layer_kinds())
    for shape in CACHE_SHAPES:
        cache, jcache = (_port_cache(arch, shape, dtype),
                         _jax_cache(arch, shape, dtype))
        try:
            want = _flat(jax_rules.cache_sharding(amesh, jcache))
        except KeyError:      # a rule reads "model" (the batch shards)
            assert "model" not in ms
            _raises_like_jax(lambda: rules.cache_sharding(ms, cache),
                             lambda: jax_rules.cache_sharding(amesh, jcache))
            continue
        got = rules.cache_sharding(ms, cache)
        shapes = _flat(jcache)
        for layer, specs in enumerate(got):
            for name, spec in specs.items():
                ref = f"b{layer % g}/{name}"
                _check_leaf(ms, amesh, f"{layer}/{name}", spec,
                            cache[layer][name].shape, want[ref],
                            shapes[ref].shape, True)


@pytest.mark.parametrize("seq_dim", [None, 1])
@pytest.mark.parametrize("batch", [1, 2, 3, 32, 128, 256, 512])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_equals_jax(mesh, batch, seq_dim):
    ms, amesh = _meshes(mesh)
    for shape in ((batch, 4096), (batch, 4096, 64), (batch,)):
        if seq_dim is not None and len(shape) < 2:
            continue
        got = rules.batch_spec(ms, shape, seq_dim)
        jspec = jax_rules.batch_spec(amesh, shape, seq_dim)
        assert got == _pad(jspec, len(shape)), (shape, got, jspec)
        assert rules.local_shape(ms, got, shape) == \
            NamedSharding(amesh, jspec).shard_shape(shape)


def test_to_placements_orders_axes_as_jax():
    """A tuple of axes on one dimension shards it over those mesh
    dimensions major to minor; an order against the mesh's raises."""
    ms = {"pod": 2, "data": 16, "model": 16}
    pl = rules.to_placements(ms, (("pod", "data"), None, "model"))
    assert [p.dim if p.is_shard() else None for p in pl] == [0, 0, 2]
    assert all(p.is_replicate() for p in rules.to_placements(ms, ()))
    with pytest.raises(ValueError, match="mesh order"):
        rules.to_placements(ms, (("data", "pod"),))


# -- constraints --------------------------------------------------------------

class _Shaped:
    def __init__(self, shape):
        self.shape, self.ndim = tuple(shape), len(shape)


#: (function name, shapes): the anchors and their fallbacks (heads that do
#: not divide the model axis: llava's 56 and qwen2's 2 kv heads; a batch
#: of 1; a sequence of 1)
CONSTRAINT_CASES = [
    ("constrain_batch_seq", [(8, 4096, 2048), (1, 4096, 2048),
                             (8, 1, 2048), (8, 2048)]),
    ("constrain_logits", [(8, 4096, 50304), (3, 7, 50304)]),
    ("constrain_heads", [(8, 4096, 56, 128), (8, 4096, 32, 128),
                         (8, 4096, 2, 128), (1, 1, 16, 64), (8, 4096, 64)]),
    ("constrain_scores", [(8, 56, 4096, 4096), (8, 32, 4096, 4096),
                          (1, 16, 1, 1)]),
]


@pytest.fixture
def captured(monkeypatch):
    """The specs each package's ``constrain`` computes, in call order."""
    seen = {"port": [], "jax": []}

    def port_constrain(x, *spec):
        seen["port"].append(constraints.fit_spec(
            rules.mesh_shape(constraints.get_mesh()), x.shape, spec))
        return x

    def jax_wsc(x, sharding):
        seen["jax"].append(_pad(sharding.spec, len(x.shape)))
        return x

    monkeypatch.setattr(constraints, "constrain", port_constrain)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", jax_wsc)
    yield seen
    constraints.set_mesh(None)
    jax_constraints.set_mesh(None)


@pytest.mark.parametrize("fn,shapes", CONSTRAINT_CASES,
                         ids=[c[0] for c in CONSTRAINT_CASES])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_constraints_drop_axes_as_jax(captured, mesh, fn, shapes):
    """Axes absent from the mesh or not dividing the dimension are
    dropped, and each anchor takes the reference's fallback."""
    ms, amesh = _meshes(mesh)
    constraints.set_mesh(ms)
    jax_constraints.set_mesh(amesh)
    for shape in shapes:
        getattr(constraints, fn)(_Shaped(shape))
        getattr(jax_constraints, fn)(_Shaped(shape))
    assert captured["port"] == captured["jax"]
    assert len(captured["port"]) == len(shapes) - (fn == "constrain_heads")


@pytest.mark.parametrize("spec", [
    (("pod", "data"), "model", None), ("data", None), ("model",),
    (("data", "model"), None), ("pod",), (None, ("pod", "data", "model")),
    (("model", "pod"),)])
@pytest.mark.parametrize("shape", [(16, 32, 7), (2, 1, 512), (512, 512, 3),
                                   (1, 4096, 1)])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_constrain_fit_equals_jax(captured, mesh, shape, spec):
    ms, amesh = _meshes(mesh)
    jax_constraints.set_mesh(amesh)
    jax_constraints.constrain(_Shaped(shape), *spec)
    assert constraints.fit_spec(ms, shape, spec) == captured["jax"][0]


def test_constraints_are_identities_without_a_mesh():
    x = torch.ones(2, 3, 4)
    assert constraints.get_mesh() is None
    for fn in ("constrain_batch_seq", "constrain_logits", "gather_fsdp"):
        assert getattr(constraints, fn)(x) is x
    assert constraints.constrain(x, "data", None, "model") is x
