"""Serving steps of the LLM path: prefill and greedy decode."""
