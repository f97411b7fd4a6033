"""NEXMark benchmark workload (Tucker et al.) as used in the paper §7.

Copies of ``repro/nexmark/{model,generator,queries}.py``; ``queries``
builds its pipelines on the port's own host engine (``core``), so
``q5(..., placement="device")`` lowers onto the port's
``DeviceWindowProcessor``."""

from .model import Person, Auction, Bid
from .generator import DisorderedNexmarkGenerator, NexmarkGenerator
from . import queries

__all__ = ["Person", "Auction", "Bid", "DisorderedNexmarkGenerator",
           "NexmarkGenerator", "queries"]
