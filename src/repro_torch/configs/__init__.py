"""Model configurations and input-shape cells of the ported LLM path (own
copies)."""
