"""Command-line entry points of the port, and the node axis of its sharded rendering (``mesh``)."""
