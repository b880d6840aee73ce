"""LLM serving with Balanced-Splitting admission (dense models)."""
