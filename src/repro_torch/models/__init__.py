"""The dense LLM family of the serving path: layers, model, decode."""
