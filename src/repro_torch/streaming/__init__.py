"""Device-tier streaming engine, ported to PyTorch: the whole dataflow
graph per device, window state as an ``(R, K)`` pane matrix updated in
place, snapshots consistent by construction at step boundaries.  Carrying
a state across from the JAX package: ``streaming.state``."""

from .window import VectorWindowSpec, window_state_init
from .executor import StreamExecutor, StreamJobConfig

__all__ = ["VectorWindowSpec", "window_state_init", "StreamExecutor",
           "StreamJobConfig"]
