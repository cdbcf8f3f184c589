"""The LLM path's steps: training (loss, AdamW, the train step) and
serving (prefill and greedy decode)."""
