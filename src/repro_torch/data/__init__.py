"""Synthetic training data of the LLM path (numpy only)."""
