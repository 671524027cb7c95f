"""The node's chip families in the Prometheus text format (exporter.py)."""
