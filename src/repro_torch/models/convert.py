"""Carry parameters and KV caches between the JAX package and the port.

The reference's trees stack each group of layers on a leading axis
(``groups/b{i}/...`` of shape ``(n_groups, ...)``); the port holds one
block per layer.  Layer ``l`` is group ``l // g``, block ``l % g`` of a
group of ``g = len(cfg.layer_kinds())`` layers.  Tensors keep the
reference's ``(in, out)`` layout, so the carry-over is a copy, never a
transpose.  ``jax.tree.map(np.asarray, tree)`` of a reference tree is what
the ``*_from_numpy`` functions take, and what ``*_to_numpy`` give back:
parameters, caches and AdamW's state (``mu`` and ``nu`` in the
parameters' layout, by parameter name in the port).
Every family's blocks carry across: an RWKV-6 block has no ``ffn``, an MoE
``ffn`` holds stacked ``(E, D, F)`` experts and a float32 router, and the
caches hold ``{k, v}`` (int8 with float16 ``k_scale``, ``v_scale``),
``{h, conv}`` or ``{wkv, tm_shift, cm_shift}``.  Round trips are exact.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .transformer import SUBS, Transformer, layer_kinds


def _tensor(a, device, dtype, kinds: str = "f") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind not in kinds or (a.dtype.kind == "f"
                                     and a.dtype.itemsize < 2):
        raise TypeError(f"expected an array of kind {kinds!r} of a numpy "
                        f"dtype, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _layer_index(cfg, layer: int):
    g = len(cfg.layer_kinds())
    return layer // g, f"b{layer % g}"


def params_from_numpy(cfg, tree: Dict, device=None, dtype=None
                      ) -> Transformer:
    """The port's :class:`Transformer` from the reference's parameter tree
    of numpy arrays; ``dtype`` (default: each array's own) casts."""
    def t(a):
        return _tensor(a, device, dtype)

    blocks = []
    for layer in range(cfg.n_layers):
        group, b = _layer_index(cfg, layer)
        gp = tree["groups"][b]
        blocks.append({sub: {name: t(a[group]) for name, a in tensors.items()}
                       for sub, tensors in gp.items()})
    return Transformer(cfg, t(tree["embed"]), blocks,
                       {k: t(a) for k, a in tree["final_norm"].items()},
                       t(tree["lm_head"]) if "lm_head" in tree else None)


def params_to_numpy(cfg, params: Transformer) -> Dict:
    """The reference's parameter tree (groups stacked) as numpy arrays."""
    return _tree_of(cfg, dict(params.named_parameters()))


def _tree_of(cfg, named: Dict[str, torch.Tensor]) -> Dict:
    """The reference's tree (groups stacked) of tensors named as the
    port's ``named_parameters()`` names them, as numpy arrays of their own
    (the training step updates its tensors in place)."""
    def n(x):
        return x.detach().cpu().numpy().copy()

    g = len(cfg.layer_kinds())
    groups = {}
    for i in range(g):
        # every sub of the block, a parameter-free norm's {} included
        subs = SUBS[:3] if layer_kinds(cfg, i)[0] == "rwkv6" else SUBS
        groups[f"b{i}"] = {sub: {} for sub in subs}
        prefix = f"blocks.{i}."
        for name in named:
            if name.startswith(prefix):
                sub, leaf = name[len(prefix):].split(".")
                groups[f"b{i}"][sub][leaf] = np.stack(
                    [n(named[f"blocks.{l}.{sub}.{leaf}"])
                     for l in range(i, cfg.n_layers, g)])
    tree = {"embed": n(named["embed"]), "groups": groups,
            "final_norm": {name.split(".", 1)[1]: n(t)
                           for name, t in named.items()
                           if name.startswith("final_norm.")}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = n(named["lm_head"])
    return tree


def opt_state_from_numpy(cfg, tree: Dict, device=None) -> Dict:
    """The port's AdamW state (``runtime.optimizer.AdamW.init``'s layout:
    ``mu`` and ``nu`` by parameter name, ``count`` 0-d int32) from the
    reference's (``{"mu", "nu"}`` as parameter trees of numpy arrays,
    ``count`` an int32 scalar)."""
    def moments(t):
        named = params_from_numpy(cfg, t, device, torch.float32)
        return {n: p.detach() for n, p in named.named_parameters()}

    return {"mu": moments(tree["mu"]), "nu": moments(tree["nu"]),
            "count": _tensor(tree["count"], device, torch.int32, kinds="i")}


def opt_state_to_numpy(cfg, opt: Dict) -> Dict:
    """The reference's AdamW state as numpy arrays, from the port's."""
    return {"mu": _tree_of(cfg, opt["mu"]), "nu": _tree_of(cfg, opt["nu"]),
            "count": opt["count"].cpu().numpy().copy()}


def cache_from_numpy(cfg, tree: Dict, device=None
                     ) -> List[Dict[str, torch.Tensor]]:
    """The port's per-layer cache from the reference's cache tree
    (``{"b{i}": {name: (n_groups, B, ...)}}``), each tensor in its own
    type (int8 codes included)."""
    out = []
    for layer in range(cfg.n_layers):
        group, b = _layer_index(cfg, layer)
        out.append({k: _tensor(a[group], device, None, kinds="fi")
                    for k, a in tree[b].items()})
    return out


def cache_to_numpy(cfg, cache: List[Dict[str, torch.Tensor]]) -> Dict:
    g = len(cfg.layer_kinds())
    return {f"b{i}": {k: np.stack([cache[l][k].cpu().numpy()
                                   for l in range(i, cfg.n_layers, g)])
                      for k in cache[i]}
            for i in range(g)}
