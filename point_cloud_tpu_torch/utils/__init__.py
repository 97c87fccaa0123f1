"""Host-side utilities of the port (stage timers)."""
