"""Example trainers of the port (counterparts of ``examples/``)."""
