"""The port's native (C++) host library, built with g++ on first use and
loaded with ctypes (`native/bindings.py`)."""
