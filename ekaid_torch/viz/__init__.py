"""Qualitative figures and the ask-a-question tools."""
