"""Carry parameters and KV caches between the JAX package and the port.

The reference's trees stack each group of layers on a leading axis
(``groups/b{i}/...`` of shape ``(n_groups, ...)``); the port holds one
block per layer.  Layer ``l`` is group ``l // g``, block ``l % g`` of a
group of ``g = len(cfg.layer_kinds())`` layers.  Tensors keep the
reference's ``(in, out)`` layout, so the carry-over is a copy, never a
transpose.  ``jax.tree.map(np.asarray, tree)`` of a reference tree is what
the ``*_from_numpy`` functions take, and what ``*_to_numpy`` give back.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .transformer import Transformer

_SUBS = ("norm1", "mixer", "norm2", "ffn")


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind != "f" or a.dtype.itemsize < 2:
        raise TypeError(f"expected a float array of a numpy dtype, got "
                        f"{a.dtype}")
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
        blocks.append({sub: {name: t(a[group]) for name, a in gp[sub].items()}
                       for sub in _SUBS})
    return Transformer(cfg, t(tree["embed"]), blocks,
                       {k: t(a) for k, a in tree["final_norm"].items()},
                       t(tree["lm_head"]) if "lm_head" in tree else None)


def params_to_numpy(cfg, params: Transformer) -> Dict:
    """The reference's parameter tree (groups stacked) as numpy arrays."""
    def n(x):
        return x.detach().cpu().numpy()

    g = len(cfg.layer_kinds())
    groups = {}
    for i in range(g):
        layers = [params.blocks[l].tensors()
                  for l in range(i, cfg.n_layers, g)]
        groups[f"b{i}"] = {sub: {name: np.stack([n(b[sub][name])
                                                 for b in layers])
                                 for name in layers[0][sub]}
                           for sub in _SUBS}
    tree = {"embed": n(params.embed), "groups": groups,
            "final_norm": {k: n(v) for k, v in params.final_norm.items()}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = n(params.lm_head)
    return tree


def cache_from_numpy(cfg, tree: Dict, device=None
                     ) -> List[Dict[str, torch.Tensor]]:
    """The port's per-layer cache from the reference's cache tree
    (``{"b{i}": {"k", "v"}}`` of ``(n_groups, B, S, Hk, dh)``)."""
    out = []
    for layer in range(cfg.n_layers):
        group, b = _layer_index(cfg, layer)
        out.append({k: _tensor(a[group], device, None)
                    for k, a in tree[b].items()})
    return out


def cache_to_numpy(cfg, cache: List[Dict[str, torch.Tensor]]) -> Dict:
    g = len(cfg.layer_kinds())
    return {f"b{i}": {k: np.stack([cache[l][k].cpu().numpy()
                                   for l in range(i, cfg.n_layers, g)])
                      for k in cache[i]}
            for i in range(g)}
