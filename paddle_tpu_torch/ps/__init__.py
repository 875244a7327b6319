"""Parameter-server layer of the port: host table, device cache, key map."""
