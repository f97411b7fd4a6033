"""PyTorch/CUDA port of the JAX package ``repro``, beside it.

The layout mirrors ``src/repro/`` so that each module's counterpart is
easy to find.  The port imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``: what it needs of a framework-free reference module
it keeps as its own copy (the host engine: ``core/`` but
``device_window.py``, ``state/``, ``snapshot/``,
``runtime/{supervisor,worker_proc,chaos}.py``, ``nexmark/``;
``models/config.py``, ``configs/``).

Ported so far: the paper's main path, ``nexmark.queries.q5(...,
placement="device")`` through the host engine (``core.JetCluster``, its
tasklets, snapshots and planner) into ``core.DeviceWindowProcessor``,
which drives the device tier on the card; the device tier,
``streaming.StreamExecutor`` over ``streaming.window``, whose stage-1 pane scatter is the hand-written Hopper
kernel ``kernels.window_agg``, on one device or one process per shard of a
``launch.mesh`` (``streaming.collectives``), where the route exchange lays
out its all-to-all with the kernels of ``kernels.route``; and LM serving,
``launch.serve.BatchedLMServer`` decoding dense GQA models
(``models``, ``configs``), whose decode attention is the hand-written
kernel ``kernels.decode_attention`` (all CUDA C++, ``kernels/csrc``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper takes its plain PyTorch version.
"""
