"""The client of the optimizer service (optimizer_client.py)."""
