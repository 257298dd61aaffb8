"""Host-side utilities of the port (``faults``: the seeded fault plan)."""
