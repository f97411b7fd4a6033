"""Activation sharding constraints.

The port of ``repro/sharding/constraints.py``.  The reference pins
activations with ``with_sharding_constraint`` at a few anchors (post-embed,
the carry between layers, the heads, the scores, the logits) so that
GSPMD's propagation never resolves a conflict by replicating the batch.
The port's activations on a mesh are DTensors, whose placements
propagate op by op; :func:`constrain` ``redistribute``s one to the spec at
the same anchors.  The launcher registers the mesh here (:func:`set_mesh`);
without a registered mesh, or on a plain tensor, every constraint is the
identity.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from .rules import mesh_shape, to_placements

_MESH = None
_CONSTANTS_DEPTH = 0


def set_mesh(mesh) -> None:
    """Register ``mesh`` (a named DeviceMesh, or None to clear)."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _axis_ok(shape, dim: int, axes) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    n = 1
    for a in axes:
        if a not in shape:
            return False
        n *= shape[a]
    return dim % n == 0 and dim >= n


def fit_spec(shape, dims, spec) -> tuple:
    """``spec`` against a mesh of ``shape`` (``{axis: size}``) for a tensor
    of ``dims``: axes absent from the mesh or not dividing the dimension
    dropped, as ``constraints.py:37-58`` drops them."""
    axes = []
    for dim, a in zip(dims, spec):
        if isinstance(a, tuple):
            a = tuple(s for s in a if s in shape)
            a = a if a and _axis_ok(shape, dim, a) else None
            if a is not None and len(a) == 1:
                a = a[0]
        elif a is not None and not _axis_ok(shape, dim, a):
            a = None
        axes.append(a)
    return tuple(axes) + (None,) * (len(dims) - len(axes))


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """``x`` redistributed to ``spec`` over the registered mesh (see
    :func:`fit_spec`); the identity without a mesh or on a plain tensor."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    fitted = fit_spec(mesh_shape(_MESH), x.shape, spec)
    placements = to_placements(_MESH, fitted)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(_MESH, placements)


BATCH = ("pod", "data")


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A parameter for its use: a DTensor sharded over ``data`` (FSDP)
    gathered over it, its ``model`` shards kept; the identity otherwise.
    Its backward reduce-scatters the gradient over ``data`` (ZeRO-3), as
    GSPMD gathers the reference's FSDP weights at their use."""
    if _MESH is None or not isinstance(w, DTensor):
        return w
    names = list(mesh_shape(_MESH))
    if "data" not in names:
        return w
    i = names.index("data")
    placements = list(w.placements)
    if placements[i].is_replicate():
        return w
    placements[i] = Replicate()
    return w.redistribute(_MESH, placements)


def constrain_batch_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) residual-stream activations: batch over (pod, data) and
    the *sequence* over ``model`` (Megatron-style sequence parallelism);
    a single position (decode) keeps only the batch."""
    if x.ndim == 3 and x.shape[1] > 1:
        return constrain(x, BATCH, "model", None)
    return constrain(x, BATCH, *([None] * (x.ndim - 1)))


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) activations into or out of a mixer, an FFN or the head:
    the batch over (pod, data), whole on ``model`` (the sequence gathered
    on the way in, the tensor-parallel partial sums reduced on the way
    out), where GSPMD gathers the reference's sequence-parallel carry for
    its tensor-parallel products.  The products' gradients then come back
    in that layout too, never sharded over the tokens of a flattened
    (batch x sequence) dimension."""
    if x.ndim != 3:
        return x
    return constrain(x, BATCH, None, None)


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits: batch over (pod, data), vocab over model."""
    return constrain(x, BATCH, None, "model")


def _model_size() -> int:
    if _MESH is None:
        return 1
    return mesh_shape(_MESH).get("model", 1)


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) q/k/v: heads on ``model`` when they divide it, else
    the sequence."""
    if x.ndim != 4:
        return x
    if x.shape[2] % _model_size() == 0:
        return constrain(x, BATCH, None, "model", None)
    return constrain(x, BATCH, "model", None, None)


def constrain_flat_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, n_heads * dh), before the split into heads: as
    :func:`constrain_heads` will place the split (the heads on ``model``,
    else the sequence), so that the split moves nothing."""
    if n_heads % _model_size() == 0:
        return constrain(x, BATCH, None, "model")
    return constrain(x, BATCH, "model", None)


def gather_unsplit_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, n_heads * dh), the attention core's output with its heads
    merged: where the heads do not divide ``model`` (the query-sequence
    fallback of :func:`constrain_heads`), gathered over the sequence, so
    that the merge's gradient comes back by sequence, not by the merged
    dim, which ``model`` cannot split into whole heads."""
    if n_heads % _model_size() == 0:
        return x
    return gather_seq(x)


def constrain_scores(x: torch.Tensor) -> torch.Tensor:
    """(B, H, Sq, Sk) attention scores: heads on ``model``, with a
    query-sequence fallback."""
    if x.shape[1] % _model_size() == 0:
        return constrain(x, BATCH, "model", None, None)
    return constrain(x, BATCH, None, "model", None)


@contextlib.contextmanager
def replicated_constants() -> Iterator[None]:
    """With a mesh registered, plain tensors that the model makes on the
    fly (positions, masks, RoPE frequencies, zero states) enter DTensor ops
    as replicated, as constants are replicated in the reference's
    program; without one, nothing changes."""
    global _CONSTANTS_DEPTH
    if _MESH is None or _CONSTANTS_DEPTH:   # torch's context nests badly
        yield
        return
    _CONSTANTS_DEPTH += 1
    try:
        with implicit_replication():
            yield
    finally:
        _CONSTANTS_DEPTH -= 1
