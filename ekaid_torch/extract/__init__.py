"""Feature extraction of the port: chest X-rays -> 52-node graph records."""
