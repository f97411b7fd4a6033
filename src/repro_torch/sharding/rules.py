"""Sharding rules: FSDP + TP (+ EP) parameter layouts, batch/sequence
activation layouts, and KV/SSM cache layouts, over a DeviceMesh.

The port of ``repro/sharding/rules.py``, with the same rule table:

* weights: tensor-parallel on ``model`` along heads / experts / ffn /
  vocab, and FSDP on ``data`` along the other large dim.  Optimizer
  moments mirror the parameters (ZeRO-3).
* activations: batch on ``(pod, data)``.
* caches: batch on ``(pod, data)`` when it divides, otherwise the
  *sequence* dim shards on ``data`` (sequence-parallel cache for
  ``long_500k``'s global batch of 1).

Every axis assignment is checked against the mesh; an axis that does not
divide the dimension is dropped (replicated), as the reference drops it,
though DTensor would accept an uneven shard.

A *spec* is the port's :class:`~jax.sharding.PartitionSpec`: a tuple with
one entry per tensor dimension, ``None``, an axis name or a tuple of axis
names.  :func:`to_placements` turns it into one DTensor placement per mesh
dimension.  JAX lays a tuple of axes on one dimension major to minor, and
DTensor shards a dimension over mesh dimensions left to right, so the two
agree when the mesh's dimensions run ``("pod", "data", "model")`` and each
tuple names its axes in that order; :func:`to_placements` raises on
another order.

The rules take a *mesh*: a :class:`~torch.distributed.device_mesh.
DeviceMesh` with dimension names, or a mapping ``{axis: size}`` in mesh
order (the production meshes' specs and shard shapes need no process
group).  The reference's trees stack each group of layers on a leading
axis; the port holds one block a layer (``models/convert.py``), so a
block's tensor has no such axis and its spec is the reference's without
the leading ``None``, as are a layer's cache entries.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

_FSDP = "data"      # FSDP shards the non-TP large dim over data
_TP = "model"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` in mesh order, of a named DeviceMesh or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs dimension names")
    return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}


def batch_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_size(shape: Mapping[str, int], axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def _fit(shape: Mapping[str, int], dim: int, axes: Axes) -> Axes:
    """``axes`` if they divide ``dim`` (trying ever shorter prefixes of a
    tuple), else None."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if dim % shape[axes] == 0 else None
    axes = tuple(a for a in axes if a in shape)
    while axes:
        if dim % _axis_size(shape, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
        axes = axes[:-1]
    return None


def _spec(shape: Mapping[str, int], dims: Sequence[int], *dim_axes) -> Spec:
    """A spec of ``dim_axes``, dropping the axes that do not divide."""
    if len(dim_axes) != len(dims):
        raise ValueError(f"{len(dim_axes)} axes for shape {tuple(dims)}")
    return tuple(_fit(shape, d, a) for d, a in zip(dims, dim_axes))


def _without(spec: Spec, axis: str) -> Spec:
    return tuple(None if a == axis else a for a in spec)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_spec(mesh, name: str, shape, fsdp: bool = True) -> Spec:
    """The rule table, keyed by the leaf's name (the last part of a
    ``named_parameters()`` name, or of an AdamW moment's).

    ``fsdp=False`` (serving): weights shard on ``model`` only, as the
    reference's bf16 inference weights do."""
    ms = mesh_shape(mesh)
    leaf = name.rsplit(".", 1)[-1]
    core = tuple(int(d) for d in shape)
    n = len(core)

    def wrap(spec: Spec) -> Spec:
        return spec if fsdp else _without(spec, _FSDP)

    # embed/lm_head: vocab-sharded only (rules.py:110-117)
    if leaf == "embed":
        return wrap(_spec(ms, core, _TP, None))
    if leaf == "lm_head":
        return wrap(_spec(ms, core, None, _TP))
    if leaf in ("wq", "wk", "wv", "wg", "wr", "in_proj", "cm_wk", "cm_wr",
                "tm_w1", "td_w1"):
        if n == 2:
            return wrap(_spec(ms, core, _FSDP, _TP))
    if leaf in ("wo", "out_proj", "cm_wv", "dt_proj", "td_w2"):
        if n == 2:
            return wrap(_spec(ms, core, _TP, _FSDP))
    if leaf in ("w_gate", "w_up"):
        if n == 2:   # dense MLP (D, F)
            return wrap(_spec(ms, core, _FSDP, _TP))
        # MoE (E, D, F): expert-parallel when E divides the model axis,
        # otherwise TP inside each expert
        if core[0] % ms[_TP] == 0:
            return wrap(_spec(ms, core, _TP, _FSDP, None))
        return wrap(_spec(ms, core, None, _FSDP, _TP))
    if leaf == "w_down":
        if n == 2:   # dense MLP (F, D)
            return wrap(_spec(ms, core, _TP, _FSDP))
        # MoE (E, F, D): as models/moe.py's _moe_sharded lays it
        if core[0] % ms[_TP] == 0:
            return wrap(_spec(ms, core, _TP, _FSDP, None))
        return wrap(_spec(ms, core, None, _TP, _FSDP))
    if leaf == "router":
        return (None,) * n     # small; the MoE's local_map wants it whole
    if leaf in ("conv_w", "x_proj", "A_log"):
        return wrap(_spec(ms, core, _TP, None))
    if leaf in ("conv_b", "dt_bias", "D"):
        return wrap(_spec(ms, core, _TP))
    if leaf == "u":
        return wrap(_spec(ms, core, _TP, None))
    # default: shard the largest dim over data if it is big and divides
    if core and max(core) >= 4096:
        axes = [None] * n
        axes[core.index(max(core))] = _FSDP
        return wrap(_spec(ms, core, *axes))
    return (None,) * n


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_sharding(mesh, params, fsdp: bool = True) -> Dict[str, Spec]:
    """``{name: spec}`` of every parameter of ``params`` (a module or a
    mapping of named tensors)."""
    return {n: param_spec(mesh, n, p.shape, fsdp=fsdp)
            for n, p in _named(params).items()}


def state_sharding(mesh, state) -> Dict[str, Any]:
    """Train state ``{params, opt: {mu, nu, count}, step}``: the moments
    mirror the parameters (ZeRO-3); ``count`` and ``step`` are
    replicated."""
    p = param_sharding(mesh, state["params"])
    opt = state["opt"]
    return {"params": p,
            "opt": {"mu": {n: param_spec(mesh, n, t.shape)
                           for n, t in opt["mu"].items()},
                    "nu": {n: param_spec(mesh, n, t.shape)
                           for n, t in opt["nu"].items()},
                    "count": ()},
            "step": ()}


# ---------------------------------------------------------------------------
# activations / batches
# ---------------------------------------------------------------------------


def batch_spec(mesh, shape, seq_dim: Optional[int] = None) -> Spec:
    """Dim 0 (batch) over ``(pod, data)``; where the batch cannot shard and
    a sequence dim is given, the sequence over ``data`` (SP)."""
    ms = mesh_shape(mesh)
    ba = batch_axes(ms)
    b = _fit(ms, shape[0], ba)
    axes = [None] * len(shape)
    if b is not None and shape[0] >= _axis_size(ms, ba):
        axes[0] = b
    elif seq_dim is not None:
        axes[seq_dim] = _fit(ms, shape[seq_dim], "data")
    return tuple(axes)


def batch_sharding(mesh, batch: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Spec]:
    return {k: batch_spec(mesh, v.shape) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def cache_spec(mesh, name: str, shape) -> Spec:
    """One layer's cache entry (``rules.py:202-242`` without the groups
    dim): k/v (B, S, Hk, dh), k_scale/v_scale (B, S, Hk), h (B, di, N),
    conv (B, K-1, di), wkv (B, H, dh, dh), tm_shift/cm_shift (B, D)."""
    ms = mesh_shape(mesh)
    ba = batch_axes(ms)
    B = int(shape[0])
    n_b = _axis_size(ms, ba)
    batch_ok = B % n_b == 0 and B >= n_b
    b = ba if batch_ok else None
    seq = _TP if batch_ok else ("data", "model")
    if name in ("k", "v"):
        # sequence-sharded over model (plus data when the batch can't)
        return _spec(ms, shape, b, seq, None, None)
    if name in ("k_scale", "v_scale"):
        return _spec(ms, shape, b, seq, None)
    if name == "h":
        return _spec(ms, shape, b, seq, None)
    if name == "conv":
        return _spec(ms, shape, b, None, seq)
    if name == "wkv":
        if batch_ok:
            return _spec(ms, shape, b, _TP, None, None)
        return _spec(ms, shape, None, _TP, "data", None)
    if name in ("tm_shift", "cm_shift"):
        return _spec(ms, shape, b, seq)
    # unknown cache entry: batch only
    axes = [None] * len(shape)
    if batch_ok:
        axes[0] = ba
    return _spec(ms, shape, *axes)


def cache_sharding(mesh, cache) -> list:
    """One ``{name: spec}`` a layer of a cache (``transformer.init_cache``'s
    list)."""
    return [{n: cache_spec(mesh, n, t.shape) for n, t in layer.items()}
            for layer in cache]


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(mesh, spec: Spec) -> Tuple[Any, ...]:
    """One placement a mesh dimension: ``Shard(d)`` on the mesh dimensions
    that ``spec[d]`` names, ``Replicate()`` on the others."""
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} run against the mesh "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, spec: Spec, shape) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape`` laid out
    by ``spec`` (every axis divides: the rules drop the others)."""
    ms = mesh_shape(mesh)
    out = []
    for d, axes in zip(shape, spec):
        n = _axis_size(ms, axes)
        if d % n:
            raise ValueError(f"axes {axes} do not divide {d}")
        out.append(int(d) // n)
    return tuple(out)


def distribute(tensor: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """The DTensor of ``tensor`` (whole and equal on every rank: made from
    one seed, or read from one file) laid out by ``spec`` over ``mesh``:
    each rank keeps its shard, and nothing moves between ranks."""
    return distribute_tensor(tensor, mesh, to_placements(mesh, spec),
                             src_data_rank=None)


@torch.no_grad()
def distribute_module(module: nn.Module, mesh,
                      specs: Mapping[str, Spec]) -> nn.Module:
    """Replace every parameter of ``module`` by its DTensor under
    ``specs`` (by ``named_parameters()`` name), in place; the parameters
    keep their ``requires_grad``.  Returns ``module``."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        dt = distribute(p.detach(), mesh, specs[name])
        sub._parameters[leaf] = nn.Parameter(dt, requires_grad=p.requires_grad)
    return module
