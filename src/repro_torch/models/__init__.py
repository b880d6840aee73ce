"""Models of the port: the dense, MoE and RWKV6 decoders (config, layers,
moe, rwkv, stages, facade)."""
