"""Example entry points of the port (counterparts of ``examples/``)."""
