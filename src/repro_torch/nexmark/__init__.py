"""NEXMark benchmark workload (Tucker et al.) as used in the paper §7.

Copies of ``repro/nexmark/{model,generator}.py``.  The queries module is
not ported yet: it builds host-engine pipelines, which the port does not
have."""

from .model import Person, Auction, Bid
from .generator import DisorderedNexmarkGenerator, NexmarkGenerator

__all__ = ["Person", "Auction", "Bid", "DisorderedNexmarkGenerator",
           "NexmarkGenerator"]
