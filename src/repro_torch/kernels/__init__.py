"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and build with ``nvcc`` at first use
(``_build``).  Ported: ``window_agg``, ``decode_attention``
(``decode_attn``).  Still to port: ``route_counts`` (see ROADMAP.md)."""
