"""Serving runtime of the port: step functions and the batched server."""
