"""Sharding over a DeviceMesh: the rule table (``rules``) that places
parameters, optimizer moments, batches and caches as DTensors, and the
activation constraints (``constraints``) the model applies at the
reference's anchors."""

from .rules import (batch_axes, batch_sharding, batch_spec, cache_sharding,
                    distribute, param_sharding, state_sharding,
                    to_placements)

__all__ = ["batch_axes", "batch_sharding", "batch_spec", "cache_sharding",
           "distribute", "param_sharding", "state_sharding", "to_placements"]
