"""Tiny event bus: typed queues with per-frame drain.

Capability parity with the reference's event plumbing — bevy ``Events`` +
the ``event_set!`` macro that bundles several writers behind one
``dispatch`` (reference: src/event_set.rs:22-50): here a single bus keyed
by event type, with ``send`` (dispatch) and ``drain`` (EventReader).

Copy of the reference's ``utils/events.py``: ``tests/test_torch_tools.py``
holds its results equal to the reference's.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Type, TypeVar

T = TypeVar("T")


class EventBus:
    def __init__(self):
        self._queues: dict[type, list[Any]] = defaultdict(list)

    def send(self, event: Any) -> None:
        self._queues[type(event)].append(event)

    def dispatch(self, *events: Any) -> None:
        """Send several events at once (event_set!'s dispatch)."""
        for event in events:
            self.send(event)

    def drain(self, event_type: Type[T]) -> list[T]:
        """Take all pending events of a type."""
        events = self._queues.get(event_type, [])
        if events:
            self._queues[event_type] = []
        return events

    def peek(self, event_type: Type[T]) -> list[T]:
        return list(self._queues.get(event_type, []))

    def clear(self) -> None:
        self._queues.clear()
