"""Runnable examples of the port (counterpart of the repository's
``examples/``)."""
