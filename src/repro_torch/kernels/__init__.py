"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and build with ``nvcc`` at first use
(``_build``).  Ported: ``window_agg``, ``decode_attention``
(``decode_attn``) and ``route_counts`` with ``route_offsets`` and the route
plan's ``route_pack`` (``route``): every TPU kernel of the JAX package has
its counterpart."""
