"""Parameter-server layer of the port: host tables, device cache and key map, the PS client, its RPC transport and the communicator."""

from .graph_table import GraphTable

__all__ = ["GraphTable"]
