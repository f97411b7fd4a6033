"""Per-(architecture x input-shape) cell builders for the dry run.

The port of ``repro/launch/specs.py``.  ``build_cell(arch, shape, mesh)``
returns a :class:`Cell`: the step function and its arguments as
meta-device DTensors placed by ``sharding.rules`` (every shape and
placement of a real run, no memory), and the cell's static facts.
``decode_*``/``long_*`` shapes run the serve step (one token against a
``seq_len`` cache), ``prefill_*`` the cache-filling prefill, ``train_*`` a
whole train step (forward, backward and the sharded AdamW update).  Where
the reference hands ``jit`` its in/out shardings, the port's arguments
carry their placements, and the registered mesh places the activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs import SHAPES, ShapeSpec, get_config
from ..models import lm, transformer
from ..models.config import ModelConfig
from ..sharding import rules
from .train import make_trainer

#: gradient-accumulation factor per arch for train_4k: the reference's
#: table (``specs.py:32-39``), kept as its configuration (its comment
#: speaks of fitting a 16 GiB v5e chip)
MICROBATCHES = {
    "jamba-v0.1-52b": 8,
    "mixtral-8x7b": 2,
    "phi3.5-moe-42b-a6.6b": 2,
    "internlm2-20b": 4,
    "llava-next-34b": 2,
    "minitron-4b": 4,
}
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable                    # fn(*args): one step
    args: Tuple[Any, ...]           # meta DTensors (and the decode pos)
    cfg: ModelConfig
    static_meta: dict


def _placed(t: torch.Tensor, mesh) -> DTensor:
    return rules.distribute(t, mesh, rules.batch_spec(mesh, t.shape))


def _batch(cfg: ModelConfig, spec: ShapeSpec, mesh) -> dict:
    B, S = spec.global_batch, spec.seq_len
    out = {"labels": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.modality == "vlm_stub" and spec.kind != "decode":
        out["embeds"] = torch.empty((B, S, cfg.d_model),
                                    dtype=torch.bfloat16, device=META)
    else:
        out["tokens"] = torch.empty((B, S), dtype=torch.int32, device=META)
    return {k: _placed(v, mesh) for k, v in out.items()}


def _serving_params(cfg: ModelConfig, mesh):
    """bf16 parameters placed model-parallel only (no FSDP), as the
    reference's serving cells place them."""
    params = lm.init_params(cfg, torch.Generator(), torch.bfloat16,
                            device=META)
    return rules.distribute_module(
        params, mesh, rules.param_sharding(mesh, params, fsdp=False))


def build_cell(arch: str, shape_name: str, mesh,
               remat_policy: str = "nothing",
               cache_dtype=torch.bfloat16) -> Cell:
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    meta = {"seq_len": spec.seq_len, "global_batch": spec.global_batch,
            "cache_dtype": str(cache_dtype).replace("torch.", "")}

    if spec.kind == "train":
        mb = MICROBATCHES.get(arch, 1)
        meta["microbatches"] = mb
        state, step = make_trainer(cfg, steps=10_000,
                                   compute_dtype=torch.bfloat16,
                                   microbatches=mb,
                                   remat_policy=remat_policy, device=META,
                                   mesh=mesh)
        return Cell(arch, shape_name, "train", step,
                    (state, _batch(cfg, spec, mesh)), cfg, meta)

    params = _serving_params(cfg, mesh)
    if spec.kind == "prefill":
        batch = _batch(cfg, spec, mesh)
        batch.pop("labels")

        def prefill_fn(params, batch):
            return transformer.prefill(
                cfg, params, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), compute_dtype=torch.bfloat16)

        return Cell(arch, shape_name, "prefill", prefill_fn,
                    (params, batch), cfg, meta)

    # decode: one token against a seq_len cache, at its last position
    B = spec.global_batch
    cache = lm.init_cache(cfg, B, spec.seq_len, cache_dtype, device=META)
    cache = [{n: rules.distribute(t, mesh, s[n]) for n, t in layer.items()}
             for layer, s in zip(cache, rules.cache_sharding(mesh, cache))]
    token = _placed(torch.empty((B,), dtype=torch.int32, device=META), mesh)
    serve = lm.make_serve_step(cfg, compute_dtype=torch.bfloat16)
    return Cell(arch, shape_name, "decode", serve,
                (params, cache, token, spec.seq_len - 1), cfg, meta)


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def argument_tensors(cell: Cell) -> list:
    """Every tensor among the cell's arguments."""
    return [t for t in _leaves(cell.args) if isinstance(t, torch.Tensor)]


def argument_bytes(cell: Cell) -> int:
    """The bytes of the arguments' shards on one device (a Python int
    argument, the decode position, counts as the int32 scalar the
    reference passes)."""
    total = 0
    for t in _leaves(cell.args):
        if isinstance(t, int):
            total += 4
            continue
        local = t.to_local() if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total
