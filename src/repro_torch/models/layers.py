"""Shared layers: norms, rotary embeddings, initializers, the SwiGLU MLP.

The port of ``repro/models/layers.py``.  Parameters are plain tensors in
dicts (an ``nn.ParameterDict`` in the model) with the reference's names,
shapes and ``(in, out)`` weight layout, so ``x @ w`` reads the same in
both packages.  ``chunked_time_scan`` is the recurrent families' scan over
time (Mamba, RWKV-6); over meta tensors it takes a counting path that the
dry run reads through :func:`repeats`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device=None) -> torch.Tensor:
    """N(0, 1) drawn in float32 from ``gen``, times ``scale``, cast to
    ``dtype``, as the reference draws it (its numbers differ: another
    generator)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_norm(cfg, dtype, device=None) -> Dict[str, torch.Tensor]:
    if cfg.norm == "nonparametric_ln":
        return {}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype,
                                    device=device),
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """RMSNorm, LayerNorm or OLMo's non-parametric LayerNorm, computed in
    float32 and cast back to the input's dtype (``layers.py:22-35``)."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.norm_eps)
        return (x * params["scale"].float()).to(dt)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
    if cfg.norm == "nonparametric_ln":          # OLMo: no learned affine
        return x.to(dt)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (arange(0, dh, 2) / dh)`` in float32, as written in
    ``layers.py:38-40``."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).
    Rotates the two halves of the head dimension (not interleaved pairs),
    angles in float32 (``layers.py:43-52``)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)            # (dh/2,)
    angles = positions[..., None].float() * freqs             # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, dtype, device=None
             ) -> Dict[str, torch.Tensor]:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = D ** -0.5, Fd ** -0.5
    return {"w_gate": normal_init(gen, (D, Fd), s_in, dtype, device),
            "w_up": normal_init(gen, (D, Fd), s_in, dtype, device),
            "w_down": normal_init(gen, (Fd, D), s_out, dtype, device)}


def mlp(params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """SwiGLU feed-forward."""
    x = x.to(compute_dtype)
    h = (F.silu(x @ params["w_gate"].to(compute_dtype))
         * (x @ params["w_up"].to(compute_dtype)))
    return h @ params["w_down"].to(compute_dtype)


def placed_zeros(shape, like: torch.Tensor, dims: Dict[int, int], dtype
                 ) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; where ``like`` is a
    DTensor, a DTensor whose dim ``dims[d]`` is sharded as ``like``'s dim
    ``d`` is, replicated elsewhere (a scan's first carry, placed as its
    inputs)."""
    z = torch.zeros(shape, dtype=dtype, device=like.device)
    if not isinstance(like, DTensor):
        return z
    placements = [Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                  else Replicate() for p in like.placements]
    return distribute_tensor(z, like.device_mesh, placements,
                             src_data_rank=None)


def _scan_per_shard(step: Callable, init, xs, chunk: int, consts):
    """:func:`chunked_time_scan` over DTensors, per shard (``local_map``):
    the recurrence is independent for every batch row and every channel
    or head, which is how its inputs are sharded, so each rank scans its
    own.  The time axis must be whole.  An input replicated on a mesh
    dimension over which the carry is split (a const such as Mamba's ``A``
    over the batch, its ``B`` and ``C`` over the channels) gets a partial
    gradient there."""
    seq = xs if isinstance(xs, tuple) else (xs,)
    if any(p.is_shard(0) for t in seq for p in t.placements):
        raise ValueError("a scan's time axis (dim 0) must not be sharded")
    mesh = init.device_mesh
    split = [not p.is_replicate() for p in init.placements]
    ins = (init, *seq, *consts)
    n = len(seq)

    def grad_placements(t):
        return tuple(Partial() if split[i] and p.is_replicate() else p
                     for i, p in enumerate(t.placements))

    def local(init, *rest):
        x = tuple(rest[:n]) if isinstance(xs, tuple) else rest[0]
        return chunked_time_scan(step, init, x, chunk, tuple(rest[n:]))

    return local_map(
        local, out_placements=(list(init.placements),
                               list(seq[0].placements)),
        in_placements=tuple(t.placements for t in ins),
        in_grad_placements=tuple(grad_placements(t) for t in ins),
        device_mesh=mesh)(*ins)


#: how many steps the ops dispatched now stand for; ``repeat(n)`` sets it
_REPEATS: List[int] = [1]


def repeats() -> int:
    """How many times the op being dispatched stands for itself: 1, or the
    steps of a chunk that one call of a meta scan's ``step`` runs for (the
    dry run's FLOP and collective counters weight each op by it; 0 for a
    call that no counter should see)."""
    return _REPEATS[-1]


@contextlib.contextmanager
def repeat(n: int) -> Iterator[None]:
    """Ops dispatched in the block stand for ``n`` of themselves; on the
    way out the scope is as it was on the way in, whatever a backward
    node's hooks (:func:`_repeat_in_backward`) left on it."""
    depth = len(_REPEATS)
    _REPEATS.append(n)
    try:
        yield
    finally:
        del _REPEATS[depth:]


@dataclasses.dataclass
class _StepProfile:
    """What one step of a scan allocates that outlives it: its outputs
    ``ys`` (shapes and types), its carry's bytes, and where a graph is
    built, the bytes of the storages it creates and saves for its backward
    (``saved``) and whether it saves its input and its output carry."""
    ys: list
    carry_bytes: int
    saved: int = 0
    saves_input_carry: bool = False
    saves_output_carry: bool = False

    def held(self, c: int) -> int:
        """The bytes that steps 0 to ``c - 3`` of a chunk hold for the
        backward when the chunk is recomputed, less the carry that
        :func:`_counted_chunk` allocates for step ``c - 3`` itself: each
        step its own saved storages, and its input carry where that is not
        the previous step's saved output."""
        extra = self.carry_bytes if (self.saves_input_carry and not
                                     self.saves_output_carry) else 0
        return ((c - 2) * (self.saved + extra)
                - self.carry_bytes * self.saves_input_carry)


def _profile_step(step: Callable, carry, x_t, consts, graph: bool
                  ) -> _StepProfile | None:
    """One step on the scan's first inputs, which no counter sees
    (``repeat(0)``), as the steps in the middle of a chunk run: with the
    carry in the graph where one is built.  None where the counting path
    cannot stand in for the steps (an output that does not own its
    storage): the scan then steps."""
    # storages are told apart by their Python objects, one a storage (as
    # the dry run's live-bytes counter also relies on)
    inputs = [t.untyped_storage() for t in (carry, *_tensors(x_t), *consts)]
    seen, packed, saves_input = weakref.WeakSet(), [0], [False]

    def pack(t):
        s = t.untyped_storage()
        if s is inputs[0]:
            saves_input[0] = True
        elif s not in seen and not any(s is o for o in inputs):
            seen.add(s)
            packed[0] += s.nbytes()

    with repeat(0), contextlib.ExitStack() as stack:
        if graph:
            stack.enter_context(torch.enable_grad())
            stack.enter_context(
                torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None))
            carry = carry.detach().requires_grad_(True)
        else:
            stack.enter_context(torch.no_grad())
        new, y = step(carry, x_t, *consts)
    ys = _tensors(y)
    if any(t.untyped_storage().nbytes() != t.numel() * t.element_size()
           for t in ys):
        return None
    return _StepProfile(
        ys=[(t.shape, t.dtype) for t in ys],
        carry_bytes=new.untyped_storage().nbytes(), saved=packed[0],
        saves_input_carry=saves_input[0],
        saves_output_carry=new.untyped_storage() in seen)


class _StandIn(torch.autograd.Function):
    """Steps 0 to ``c - 3`` of a chunk in the counting path: returns a carry
    shaped as ``carry`` (step ``c - 3``'s) that depends on the chunk's
    inputs, and holds ``held`` bytes for the backward (what those steps
    save); the gradient passes to the chunk's first carry unchanged."""

    @staticmethod
    def forward(ctx, carry, held: int, *xs):
        ctx.save_for_backward(torch.empty((held,), dtype=torch.uint8,
                                          device=carry.device))
        return torch.empty_like(carry)

    @staticmethod
    def backward(ctx, grad):
        return (grad, None) + (None,) * (len(ctx.needs_input_grad) - 2)


def _repeat_in_backward(outs, ins, n: int) -> None:
    """Weight by ``n`` the backward of the ops between tensors ``ins`` and
    ``outs`` (one step's graph): each of their nodes enters ``repeat(n)``
    before it runs and leaves after."""
    stop = {t.grad_fn for t in ins if t.grad_fn is not None}
    todo = [t.grad_fn for t in outs if t.grad_fn is not None]
    nodes = set()
    while todo:
        node = todo.pop()
        if node in nodes or node in stop or \
                type(node).__name__ == "AccumulateGrad":
            continue
        nodes.add(node)
        if len(nodes) > 10_000:
            raise RuntimeError("a scan step's graph reaches past its inputs "
                               "(a tensor captured by the step, not passed "
                               "as a const?)")
        todo.extend(f for f, _ in node.next_functions if f is not None)

    def enter(grads):
        _REPEATS.append(n)

    def leave(grads_in, grads_out):
        _REPEATS.pop()

    for node in nodes:
        node.register_prehook(enter)
        node.register_hook(leave)


def _counted_chunk(step: Callable, consts, tupled: bool, prof: _StepProfile,
                   graph: bool) -> Callable:
    """The body of one chunk of ``c >= 3`` steps over meta tensors, in the
    place of the step-by-step loop: two calls of ``step``, as step ``c - 2``
    for steps 0 to ``c - 2`` (``repeat(c - 1)``, in its backward too) and as
    step ``c - 1``; the outputs of steps 0 to ``c - 3`` and the carry of
    step ``c - 3`` are allocations of their size, and where the chunk is
    recomputed for its backward (its second call), :class:`_StandIn` holds
    what those steps would save.  A fresh body a chunk: its calls tell the
    checkpointed forward from the recompute."""
    calls = [0]

    def body(carry, *x_chunk):
        calls[0] += 1
        c = x_chunk[0].shape[0]

        def x_at(t):
            x_t = tuple(x[t] for x in x_chunk)
            return x_t if tupled else x_t[0]

        with repeat(1):
            stubs = [torch.empty((c - 2, *shape), dtype=dtype,
                                 device=carry.device)
                     for shape, dtype in prof.ys]
            if graph:
                held = prof.held(c) if calls[0] > 1 else 0
                prev = _StandIn.apply(carry, held, *x_chunk)
            else:
                prev = torch.empty_like(carry)
            x_t = x_at(c - 2)
            with repeat(c - 1):
                mid, y_mid = step(prev, x_t, *consts)
            if graph and calls[0] == 1:
                _repeat_in_backward((mid, *_tensors(y_mid)),
                                    (prev, *_tensors(x_t), *consts), c - 1)
            del prev
            carry, y_last = step(mid, x_at(c - 1), *consts)
            ys = tuple(torch.cat([stub, a[None], b[None]]) for stub, a, b
                       in zip(stubs, _tensors(y_mid), _tensors(y_last)))
        return carry, ys if isinstance(y_last, tuple) else ys[0]

    return body


def _tensors(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def chunked_time_scan(step: Callable, init, xs, chunk: int = 256,
                      consts: tuple = ()) -> Tuple[object, object]:
    """``carry, y = step(carry, x_t, *consts)`` over the time-major
    leading axis of ``xs`` (a tensor or a tuple of tensors); returns
    ``(carry, ys)`` with ``ys`` stacked time-major (a tensor, or a tuple
    where ``step`` returns one).  On a mesh (DTensor inputs, ``init``
    placed as the carry, e.g. by :func:`placed_zeros`) the scan runs per
    shard (:func:`_scan_per_shard`) and returns DTensors placed as
    ``init`` and ``xs``' first tensor.

    As in the reference (``layers.py:73-97``), time runs in chunks of
    ``chunk`` steps (halved until it divides the length), and where a
    graph is built each chunk is checkpointed: the backward pass keeps the
    carry only at chunk boundaries and runs a chunk again to get its
    steps', O(T / chunk + chunk) carries instead of O(T).  The values do
    not depend on ``chunk``.

    Over meta tensors (the dry run), where a chunk has 3 steps or more,
    the scan counts instead of stepping: each chunk calls ``step`` twice
    (:func:`_counted_chunk`), O(T / chunk) calls in all.  Its contract:
    under the dry run's counters (``launch/dryrun.py``) it gives the same
    FLOPs and collective calls and bytes as the step-by-step loop (each op
    of the two calls weighted by the steps it stands for, :func:`repeats`,
    in the backward too), and the same peak of live bytes (at each step of
    the loop where its live bytes peak, in the forward, the chunk's
    recompute and its backward, the same bytes are alive, the steps it
    does not run standing in as allocations of their size).  This holds
    for a ``step`` that is a function of its arguments alone and returns
    outputs of its own, as Mamba's and RWKV-6's are.  On every other
    device the scan steps through time."""
    seq = xs if isinstance(xs, tuple) else (xs,)
    if isinstance(seq[0], DTensor):
        return _scan_per_shard(step, init, xs, chunk, consts)
    T = seq[0].shape[0]
    c = min(chunk, T)
    while T % c:
        c //= 2
    graph = torch.is_grad_enabled() and any(x.requires_grad for x in seq)

    def run(carry, *x_chunk):
        ys = []
        for t in range(x_chunk[0].shape[0]):
            x_t = tuple(x[t] for x in x_chunk)
            carry, y = step(carry, x_t if isinstance(xs, tuple) else x_t[0],
                            *consts)
            ys.append(y)
        if isinstance(ys[0], tuple):
            return carry, tuple(torch.stack(y) for y in zip(*ys))
        return carry, torch.stack(ys)

    prof = None
    if c >= 3 and seq[0].device.type == "meta":
        x0 = tuple(x[0] for x in seq)
        prof = _profile_step(step, init, x0 if isinstance(xs, tuple)
                             else x0[0], consts, graph)
    carry, chunks = init, []
    for lo in range(0, T, c):
        body, kw = run, {}
        if prof is not None:
            body = _counted_chunk(step, consts, isinstance(xs, tuple), prof,
                                  graph)
            # the stand-in saves no bytes in the forward, its held bytes
            # in the recompute
            kw = {"determinism_check": "none"}
        if graph:
            body = functools.partial(checkpoint, body, use_reentrant=False,
                                     **kw)
        carry, ys = body(carry, *(x[lo:lo + c] for x in seq))
        chunks.append(ys)
    if isinstance(chunks[0], tuple):
        return carry, tuple(torch.cat(y) for y in zip(*chunks))
    return carry, torch.cat(chunks)
