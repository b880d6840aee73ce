"""LLM serving with Balanced-Splitting admission (dense and MoE models)."""
