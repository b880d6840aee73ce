"""Models of the port: the dense, MoE, RWKV6 and hybrid decoders (config,
layers, moe, rwkv, mamba, stages, facade)."""
