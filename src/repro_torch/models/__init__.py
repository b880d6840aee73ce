"""Models of the port: the dense and MoE decoders (config, layers, moe,
stages, facade)."""
