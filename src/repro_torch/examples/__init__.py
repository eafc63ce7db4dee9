"""Runnable examples on the port (counterparts of the repository's ``examples/``)."""
