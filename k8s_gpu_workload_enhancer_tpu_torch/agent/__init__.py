"""The node agent (agent.py) and the client of the optimizer service
(optimizer_client.py)."""
