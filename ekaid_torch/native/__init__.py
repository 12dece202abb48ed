"""The port's native (C++) host library, built with g++ on first use and
loaded with ctypes (`native/bindings.py`)."""

from ekaid_torch.native.bindings import (  # noqa: F401
    exact_match, match_disease, spatial_adjacency_batch)
