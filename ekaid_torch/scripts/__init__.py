"""Measurement scripts of the port, run as `python -m ekaid_torch.scripts.<name>`."""
