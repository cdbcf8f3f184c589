"""Model configurations of the ported LLM serving path (own copies)."""
