"""Multi-stream batching of the port (one device)."""
