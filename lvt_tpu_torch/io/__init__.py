"""Input for the port: the dataset-free synthetic world (numpy only)."""
