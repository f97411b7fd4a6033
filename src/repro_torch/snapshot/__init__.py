"""Exactly-once delivery endpoints (paper §4.5): transactional and
idempotent sinks, active-active deployment helper.

Copies of ``repro/snapshot/*`` on the port's host engine
(``repro_torch.core``)."""

from .sinks import (ExternalCollector, IdempotentSink,
                    TransactionalSink)
from .active_active import ActiveActiveRunner

__all__ = ["ExternalCollector", "IdempotentSink",
           "TransactionalSink", "ActiveActiveRunner"]
