"""The port's dry runs (``launch/specs.py``, ``launch/dryrun.py``,
``launch/dryrun_streaming.py``) against the JAX package's cell builders.

* The bytes of one device's shards of every cell's arguments, for all 33
  ``applicable_cells()`` on the 16x16 and the 2x16x16 mesh, equal the
  bytes of the reference cell's arguments under its in-shardings
  (``NamedSharding(...).shard_shape`` on ``jax.sharding.AbstractMesh``),
  exactly.  The port's cells are built in a fake world of 512 ranks in
  this process (torn down after the module).
* The reference test's three cells (``tests/test_dryrun_multipod.py``:
  olmo-1b/train_4k and qwen2-1.5b/decode_32k on 2x16x16, rwkv6-7b/
  long_500k on 16x16) run their step under the counters, each in a
  subprocess of its own, and give an estimate: positive FLOPs,
  collective bytes and a peak at least the arguments, within one H100's
  80 GB.
* The streaming dry run's state bytes a rank equal the reference state's
  with its panes split over the 16 ``data`` shards, for both exchange
  plans, and its step hands the collectives what the plan moves (the
  reduce plan: the whole (ring, K) panes; the route plan: a (16, 4, C)
  buffer).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import applicable_cells as jax_cells  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.streaming.window import (  # noqa: E402
    VectorWindowSpec as JaxSpec, window_state_init as jax_state_init)
from repro_torch.configs import applicable_cells  # noqa: E402
from repro_torch.launch import dryrun, dryrun_streaming, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
#: tests/test_dryrun_multipod.py's cells
REFERENCE_CELLS = [("olmo-1b", "train_4k", True),
                   ("qwen2-1.5b", "decode_32k", True),
                   ("rwkv6-7b", "long_500k", False)]
CELL_SCRIPT = textwrap.dedent('''
    import json, sys
    from repro_torch.launch.dryrun import run_cell
    r = run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == "1")
    print("RESULT " + json.dumps(r))
''')


@pytest.fixture(scope="module", autouse=True)
def reference_cells(tmp_path_factory):
    """The three reference cells, each started at once in a subprocess;
    ``reference_cells[key]()`` waits for one and returns its result."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = tmp_path_factory.mktemp("dryrun")
    script = base / "cell.py"
    script.write_text(CELL_SCRIPT)
    procs = {}
    for arch, shape, mp in REFERENCE_CELLS:
        log = open(base / f"{arch}__{shape}.log", "w+")
        procs[arch, shape] = (subprocess.Popen(
            [sys.executable, str(script), arch, shape, "1" if mp else "0"],
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
def world():
    with dryrun.fake_world(512):
        yield


def _jax_bytes(arch, shape, multi_pod) -> int:
    shape_, axes = MESHES[multi_pod]
    cell = jax_specs.build_cell(arch, shape, AbstractMesh(shape_, axes))
    total = 0
    for arg, sh in zip(cell.args, cell.in_shardings):
        leaves = jax.tree.leaves(arg)
        shardings = jax.tree.leaves(
            sh, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(leaves) == len(shardings)
        for leaf, s in zip(leaves, shardings):
            local = s.shard_shape(tuple(leaf.shape))
            total += int(np.prod(local, dtype=np.int64)) * \
                jnp.dtype(leaf.dtype).itemsize
    return total


def test_applicable_cells_are_the_reference_cells():
    assert applicable_cells() == jax_cells()
    assert len(applicable_cells()) == 33


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", jax_cells())
def test_argument_bytes_equal_jax(world, arch, shape, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cell = specs.build_cell(arch, shape, mesh)
    assert specs.argument_bytes(cell) == _jax_bytes(arch, shape, multi_pod)


@pytest.mark.parametrize("arch,shape,multi_pod", REFERENCE_CELLS)
def test_reference_cells_give_an_estimate(reference_cells, arch, shape,
                                          multi_pod):
    r = reference_cells[arch, shape]()
    assert r["chips"] == (512 if multi_pod else 256)
    assert r["flops"] > 0 and r["collectives"]["total_bytes"] > 0
    mem = r["memory"]
    assert mem["argument_bytes"] == _jax_bytes(arch, shape, multi_pod)
    assert mem["argument_bytes"] <= mem["peak_bytes"] < dryrun.HBM_BYTES
    assert r["fits_80gb"] is True


@pytest.mark.parametrize("exchange", ["reduce", "route"])
def test_streaming_dryrun_state_bytes(world, exchange):
    keys = batch = 1 << 16
    r = dryrun_streaming.run(exchange, keys=keys, batch_size=batch)
    spec = JaxSpec(size_ms=10_000, slide_ms=10, n_key_buckets=keys,
                   max_windows_per_step=2, ring_margin=24)
    state = jax.eval_shape(lambda: jax_state_init(spec))
    want = sum(int(np.prod(v.shape)) * jnp.dtype(v.dtype).itemsize
               for k, v in state.items() if k != "panes")
    want += spec.ring_len * keys // 16 * 4
    assert r["meta"]["data_shards"] == 16
    assert r["state_bytes_per_rank"] == r["snapshot_bytes_per_rank"] == want
    assert r["panes_shape"] == [spec.ring_len, keys // 16]
    assert r["snapshot"]["collective_bytes"] == spec.ring_len * keys // 16 * 4
    if exchange == "reduce":
        assert r["step"]["collective_bytes"] >= spec.ring_len * keys * 4
    else:
        assert r["step"]["collective_bytes"] < spec.ring_len * keys // 16
    assert r["step"]["host_staged_bytes"] == 0
