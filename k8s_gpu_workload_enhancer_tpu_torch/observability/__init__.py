"""The request flight recorder (flight.py): the replica half of end-to-end tracing."""
