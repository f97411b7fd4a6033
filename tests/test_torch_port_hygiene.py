"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""

import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    """Every import statement, top level or inside a function."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax_or_reference():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))
    for name in ("repro_torch.streaming.executor",
                 "repro_torch.core.device_window", "repro_torch.core.engine",
                 "repro_torch.nexmark.queries", "repro_torch.core.shm_ring",
                 "repro_torch.runtime.worker_proc",
                 "repro_torch.runtime.chaos", "repro_torch.snapshot.sinks",
                 "repro_torch.snapshot.active_active",
                 "repro_torch.models.moe", "repro_torch.models.mamba",
                 "repro_torch.models.rwkv6", "repro_torch.runtime.optimizer",
                 "repro_torch.runtime.checkpoint",
                 "repro_torch.runtime.compression",
                 "repro_torch.runtime.data", "repro_torch.launch.train",
                 "repro_torch.sharding.rules",
                 "repro_torch.sharding.constraints",
                 "repro_torch.sharding.collectives",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                 "repro_torch.launch.dryrun_streaming"):
        assert name in modules, name
    script = textwrap.dedent(f"""
        import importlib, sys
        for name in ["repro_torch"] + {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        # importing the host engine creates no CUDA context (the
        # multiprocess backend forks its workers after import)
        import torch
        assert not torch.cuda.is_initialized()
        print("CLEAN", len({modules!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout


@pytest.mark.parametrize("tree", ["src/repro_torch", "src/repro"])
def test_jetlint_finds_nothing(tree):
    """The engine's contract checker (``python -m repro.analysis``, the
    reference's tool, run on its own in a subprocess) reports 0 findings
    over the port's copies and over the reference: snapshot completeness
    (the bridge's ``EPHEMERAL_STATE``), aliasing, hot-path blocking and
    the rest."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro.analysis", tree],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jetlint: 0 finding(s)" in proc.stdout, proc.stdout
