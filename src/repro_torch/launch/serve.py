"""Serving: batched request decoding, in PyTorch.

The port of ``repro/launch/serve.py``: a continuous-batching decode loop
over a fixed slot count with credit-based admission and host-side request
bookkeeping.  It runs on ``cuda`` unless built with ``device="cpu"``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b

It keeps the reference's behaviour exactly, quirks included:

* a request takes the slot ``free.pop()`` returns, the last one freed;
* one global ``pos`` for every slot, advanced once per step;
* every slot decodes every step, idle ones on their previous token;
* a request admitted into a reused slot sees the previous request's cache
  rows below its start (rows are masked only by ``k_pos <= pos``);
* ``main``'s ``max_seq`` formula (``serve.py:100-101``); past it, the cache
  write clamps to the last row (``models/attention.py``).

The step's one read from the device is the greedy tokens, which the host
bookkeeping needs; ``host_reads`` counts it.  The next step's feed starts
from that host copy, where the reference reads ``self.tokens`` again
(``np.array(self.tokens)``, which JAX serves from the copy it kept).
Parameters live in ``compute_dtype`` on the server's device: the server
moves and casts the module it is given in place (``nn.Module.to``), once.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from ..configs import get_config
from ..devices import resolve_device
from ..models import lm


class BatchedLMServer:
    """Continuous-batching decode loop over a fixed slot count."""

    def __init__(self, cfg, params, batch_slots: int = 8,
                 max_seq: int = 512, compute_dtype=torch.float32,
                 device=None):
        self.device = resolve_device(device, "the server")
        self.cfg = cfg
        self.params = params.to(device=self.device, dtype=compute_dtype)
        self.B = batch_slots
        self.max_seq = max_seq
        self.serve = lm.make_serve_step(cfg, compute_dtype)
        self.cache = lm.init_cache(cfg, batch_slots, max_seq, compute_dtype,
                                   device=self.device)
        self.tokens = torch.zeros((batch_slots,), dtype=torch.int32,
                                  device=self.device)
        self._host_tokens = np.zeros((batch_slots,), np.int32)
        # slot bookkeeping (host side)
        self.free: List[int] = list(range(batch_slots))
        self.active: Dict[int, dict] = {}
        self.pos = 0
        self.completed: List[dict] = []
        self.host_reads = 0

    def submit(self, request_id, prompt: List[int], max_new: int) -> bool:
        """Admit a request if a slot is free (credit-based admission)."""
        if not self.free:
            return False
        slot = self.free.pop()
        self.active[slot] = {"id": request_id, "prompt": list(prompt),
                             "out": [], "max_new": max_new, "fed": 0}
        return True

    def step(self) -> None:
        """One global decode step: each active slot either consumes its
        next prompt token (sequential prefill) or appends a generation."""
        feed = self._host_tokens.copy()
        for slot, req in self.active.items():
            if req["fed"] < len(req["prompt"]):
                feed[slot] = req["prompt"][req["fed"]]
        next_tok, self.cache = self.serve(
            self.params, self.cache,
            torch.from_numpy(feed).to(self.device), self.pos)
        self.pos += 1
        out = next_tok.cpu().numpy()          # the step's one host read
        self.host_reads += 1
        done = []
        for slot, req in self.active.items():
            if req["fed"] < len(req["prompt"]):
                req["fed"] += 1
                if req["fed"] == len(req["prompt"]):
                    req["out"].append(int(out[slot]))
            else:
                req["out"].append(int(out[slot]))
            if len(req["out"]) >= req["max_new"]:
                done.append(slot)
        for slot in done:
            req = self.active.pop(slot)
            self.completed.append(req)
            self.free.append(slot)
        self.tokens = next_tok
        self._host_tokens = out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device, "the server")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, torch.float32, device=device)
    server = BatchedLMServer(cfg, params, batch_slots=args.slots,
                             max_seq=args.prompt_len + args.max_new
                             + args.requests * 4 + 8, device=device)
    rng = np.random.RandomState(args.seed)
    pending = [(i, rng.randint(0, cfg.vocab_size,
                               args.prompt_len).tolist())
               for i in range(args.requests)]
    t0 = time.time()
    steps = 0
    while pending or server.active:
        while pending and server.submit(pending[0][0], pending[0][1],
                                        args.max_new):
            pending.pop(0)
        server.step()
        steps += 1
        if steps > 100_000:
            raise RuntimeError("server did not drain")
    dt = time.time() - t0
    n_tok = sum(len(r["out"]) for r in server.completed)
    print(f"served {len(server.completed)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s, {steps} steps) on "
          f"{server.device}")
    return server.completed


if __name__ == "__main__":
    main()
