"""LLM serving with Balanced-Splitting admission (dense, MoE and RWKV6
models)."""
