"""The benchmark's plain reference: the EKAID model in float32 PyTorch
(`model.py`). It imports nothing of the program under test, and no
JAX."""
