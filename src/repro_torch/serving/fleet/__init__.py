"""Fleet serving, the port: so far the wire codec (``wire.py``), the JAX
package's byte format for commands, replies and slot snapshots.  The
transport, the worker and the fleet router come with their slice."""
