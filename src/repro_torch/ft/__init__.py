"""Fault tolerance of the LLM training path: re-mesh plans, stragglers."""
