"""The counting path of ``layers.chunked_time_scan`` over meta tensors (the
dry run's recurrent cells) against the step-by-step loop it stands in for.

* Function level, on a fake world of 256 ranks and its 16x16 mesh:
  RWKV-6's ``_wkv_step`` and Mamba's ``_ssm_step`` scanned over meta
  DTensors placed as the models place them, without a graph and with one
  (forward, then the backward of every input), at chunk counts of 1 to 4
  with chunks of 3 to 16 steps, one of them shorter than ``chunk``.  Under
  the dry run's three counters the FLOPs, the collective calls and bytes,
  and the peak and final live bytes equal the loop's (the loop forced by
  the branch the scan takes where it cannot stand in for a step:
  ``layers._profile_step`` returning None), exactly; the counting path
  calls ``step`` twice a chunk and once more for its profile.
* The counters weight an op by ``layers.repeats()``: a collective under
  ``repeat(3)`` counts three calls and three times its bytes.
* End to end, each in a subprocess as ``tests/test_torch_dryrun.py`` runs
  its cells: rwkv6-7b's ``train_4k`` cut to 1 layer and jamba's
  ``prefill_32k`` cut to 8 layers (7 Mamba, one attention, 4 MoE), both
  at seq 512 on 16x16: the cell's whole record equals the loop's but for
  its seconds.
* On the CPU the scan steps: ``step`` runs T times and the result equals
  a plain loop over time, exactly.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    Replicate, Shard, distribute_tensor)

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import layers, mamba, rwkv6  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
META = torch.device("meta")
#: (T, chunk): 4 chunks of 16, 5 of 8 (16 halved), one of 7 (shorter than
#: chunk), 3 of 3
LENGTHS = [(64, 16), (40, 16), (7, 8), (9, 3)]
#: (arch, shape, layers, seq): one cut cell a family
CUT_CELLS = [("rwkv6-7b", "train_4k", 1, 512),
             ("jamba-v0.1-52b", "prefill_32k", 8, 512)]
CELL_SCRIPT = textwrap.dedent('''
    import dataclasses, json, sys
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import layers
    arch, shape, n_layers, seq, counted = sys.argv[1:]
    if counted == "0":
        layers._profile_step = lambda *args: None
    cfg = dataclasses.replace(get_config(arch), n_layers=int(n_layers))
    specs.get_config = lambda name: cfg
    specs.SHAPES = dict(SHAPES, **{shape: dataclasses.replace(
        SHAPES[shape], seq_len=int(seq))})
    r = dryrun.run_cell(arch, shape, multi_pod=False)
    print("RESULT " + json.dumps(r))
''')


@pytest.fixture(scope="module", autouse=True)
def cut_cells(tmp_path_factory):
    """Each cut cell twice (the loop, the counting path), all started at
    once in subprocesses; ``cut_cells[key]()`` waits for one's record."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = tmp_path_factory.mktemp("scan")
    script = base / "cell.py"
    script.write_text(CELL_SCRIPT)
    procs = {}
    for arch, shape, n_layers, seq in CUT_CELLS:
        for counted in ("0", "1"):
            log = open(base / f"{arch}__{counted}.log", "w+")
            procs[arch, counted] = (subprocess.Popen(
                [sys.executable, str(script), arch, shape, str(n_layers),
                 str(seq), counted],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=base), log)

    def result(key):
        proc, log = procs[key]
        rc = proc.wait(timeout=TIMEOUT_S)
        log.seek(0)
        out = log.read()
        assert rc == 0, out[-3000:]
        line = [l for l in out.splitlines() if l.startswith("RESULT ")][0]
        return json.loads(line[len("RESULT "):])

    yield {key: (lambda key=key: result(key)) for key in procs}
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@pytest.fixture(scope="module")
def mesh():
    with dryrun.fake_world(256):
        yield make_production_mesh(multi_pod=False, device_type="cpu")


def _placed(mesh, shape, dtype, placements):
    return distribute_tensor(torch.empty(shape, dtype=dtype, device=META),
                             mesh, placements, src_data_rank=None)


def _scan_inputs(mesh, family: str, T: int):
    """The scan's inputs as the models place them, time-major: the batch on
    ``data``, the heads (RWKV-6) or channels (Mamba) on ``model``; with
    the step and its const.  Global batch 32: 2 rows a shard."""
    heads = [Shard(1), Shard(2)]
    if family == "rwkv6":
        H, dh = 32, 64
        xs = tuple(_placed(mesh, (T, 32, H, dh), dt, heads)
                   for dt in (torch.bfloat16,) * 3 + (torch.float32,))
        const = _placed(mesh, (H, dh), torch.float32,
                        [Replicate(), Shard(0)])
        init = layers.placed_zeros((32, H, dh, dh), xs[0], {1: 0, 2: 1},
                                   torch.float32)
        step = rwkv6._wkv_step
    else:
        di, N = 1024, 64
        rows = [Shard(1), Replicate()]
        xs = (_placed(mesh, (T, 32, di), torch.bfloat16, heads),
              _placed(mesh, (T, 32, di), torch.bfloat16, heads),
              _placed(mesh, (T, 32, N), torch.bfloat16, rows),
              _placed(mesh, (T, 32, N), torch.bfloat16, rows))
        const = _placed(mesh, (di, N), torch.float32,
                        [Replicate(), Shard(0)])
        init = layers.placed_zeros((32, di, N), xs[0], {1: 0, 2: 1},
                                   torch.float32)
        step = mamba._ssm_step
    return xs, const, init, step


def _counted_scan(mesh, family, T, chunk, graph, calls):
    """One scan (and with ``graph`` its backward) under the dry run's three
    counters; ``calls[0]`` counts the calls of ``step``."""
    xs, const, init, step = _scan_inputs(mesh, family, T)
    if graph:
        xs = tuple(x.detach().requires_grad_(True) for x in xs)
        const = const.detach().requires_grad_(True)

    def counting_step(carry, inp, c):
        calls[0] += 1
        return step(carry, *inp, c)

    memory = dryrun.LiveBytes([t.to_local() for t in (*xs, const, init)])
    args = memory.live
    flops = dryrun.LocalFlopCounter(display=False)
    comms = dryrun.CollectiveCounter()
    with memory, flops, comms, torch.set_grad_enabled(graph):
        carry, ys = layers.chunked_time_scan(counting_step, init, xs,
                                             chunk, (const,))
        if graph:
            grads = torch.autograd.grad(ys.float().sum() + carry.sum(),
                                        (*xs, const))
            del grads
        del carry, ys
    return {"flops": flops.get_total_flops(), "collectives": comms.summary(),
            "peak": memory.peak, "live": memory.live, "args": args}


@pytest.mark.parametrize("graph", [False, True], ids=["no_graph", "graph"])
@pytest.mark.parametrize("T,chunk", LENGTHS)
@pytest.mark.parametrize("family", ["rwkv6", "mamba"])
def test_meta_scan_counts_equal_the_loop(mesh, monkeypatch, family, T,
                                        chunk, graph):
    loop_calls, counted_calls = [0], [0]
    counted = _counted_scan(mesh, family, T, chunk, graph, counted_calls)
    monkeypatch.setattr(layers, "_profile_step", lambda *args: None)
    loop = _counted_scan(mesh, family, T, chunk, graph, loop_calls)
    assert counted == loop
    assert loop["flops"] > 0 and loop["peak"] > loop["args"]
    c = min(chunk, T)
    while T % c:
        c //= 2
    passes = 2 if graph else 1        # the forward, the chunk's recompute
    assert loop_calls[0] == passes * T
    assert counted_calls[0] == 1 + passes * 2 * (T // c)


def test_counters_weight_an_op_by_repeats(mesh):
    x = torch.empty((1024,), dtype=torch.float32, device=META)
    y = torch.empty((64, 64), dtype=torch.float32, device=META)
    flops = dryrun.LocalFlopCounter(display=False)
    comms = dryrun.CollectiveCounter()
    with flops, comms:
        dist.all_reduce(x)
        y @ y
        with layers.repeat(3):
            dist.all_reduce(x)
            y @ y
        with layers.repeat(0):
            dist.all_reduce(x)
            y @ y
    summary = comms.summary()
    assert summary["calls"] == {"all_reduce": 4}
    assert summary["bytes"] == {"all_reduce": 4 * 4096}
    assert flops.get_total_flops() == 4 * 2 * 64 ** 3
    assert layers.repeats() == 1


@pytest.mark.parametrize("arch,shape,n_layers,seq", CUT_CELLS)
def test_cut_cell_record_equals_the_loop(cut_cells, arch, shape, n_layers,
                                         seq):
    loop, counted = cut_cells[arch, "0"](), cut_cells[arch, "1"]()
    for r in (loop, counted):
        del r["build_s"], r["step_s"]
    assert counted == loop
    assert loop["flops"] > 0 and loop["collectives"]["total_bytes"] > 0
    assert loop["memory"]["peak_bytes"] > loop["memory"]["argument_bytes"]


@pytest.mark.parametrize("graph", [False, True], ids=["no_graph", "graph"])
def test_cpu_scan_steps_through_time(graph):
    """A CPU scan calls ``step`` at every time step (twice with a graph:
    the forward and the chunk's recompute) and gives what a plain loop
    over time gives."""
    gen = torch.Generator().manual_seed(0)
    T, B, di, N = 20, 2, 6, 4
    xs = (torch.randn(T, B, di, generator=gen),
          torch.rand(T, B, di, generator=gen) * 0.1,
          torch.randn(T, B, N, generator=gen),
          torch.randn(T, B, N, generator=gen))
    A = -torch.rand((di, N), generator=gen)
    h0 = torch.zeros((B, di, N))
    calls = [0]

    def step(h, inp, A):
        calls[0] += 1
        return mamba._ssm_step(h, *inp, A)

    h, ys = h0, []
    for t in range(T):
        h, y = mamba._ssm_step(h, *(x[t] for x in xs), A)
        ys.append(y)
    if graph:
        xs = tuple(x.requires_grad_(True) for x in xs)
    with torch.set_grad_enabled(graph):
        got_h, got_ys = layers.chunked_time_scan(step, h0, xs, chunk=8,
                                                 consts=(A,))
        if graph:
            torch.autograd.grad(got_ys.sum() + got_h.sum(), xs)
    assert calls[0] == (2 if graph else 1) * T
    assert torch.equal(got_h, h) and torch.equal(got_ys, torch.stack(ys))
