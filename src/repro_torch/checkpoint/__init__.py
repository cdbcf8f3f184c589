"""Atomic training checkpoints of the LLM path."""
