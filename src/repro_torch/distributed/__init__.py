"""Distributed helpers of the port: so far the atomic checkpoint store
(``checkpoint.py``) the fleet router persists its failover snapshots to."""
