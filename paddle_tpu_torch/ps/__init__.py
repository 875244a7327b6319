"""Parameter-server layer of the port: host tables, device cache and key map, the PS client, its RPC transport and the communicator."""
