"""PyTorch/CUDA port of the device tier, beside the JAX package ``repro``.

The layout mirrors ``src/repro/`` so that each module's counterpart is
easy to find.  The port imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``: what it needs of a framework-free reference module
it keeps as its own copy (``core/events.py``, ``nexmark/model.py``,
``nexmark/generator.py``).

Ported so far: the single-device device tier, ``streaming.StreamExecutor``
over ``streaming.window``, whose stage-1 pane scatter is the hand-written
Hopper kernel ``kernels.window_agg`` (CUDA C++, ``kernels/csrc``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""
