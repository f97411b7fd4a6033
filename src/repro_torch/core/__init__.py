"""Stream items of the Jet core.  Only ``events.py`` is ported so far: a copy
of ``repro/core/events.py``, which the NEXMark generator's columnar form
needs for :class:`EventBlock`."""

from .events import (Barrier, DONE, Event, EventBlock, LateEvent, Watermark,
                     block_form)

__all__ = ["Barrier", "DONE", "Event", "EventBlock", "LateEvent", "Watermark",
           "block_form"]
