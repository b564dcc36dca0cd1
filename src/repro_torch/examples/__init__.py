"""Runnable examples of the port (twins of the JAX package's
``examples/``); each module runs only as a script or through its
``run`` function."""
