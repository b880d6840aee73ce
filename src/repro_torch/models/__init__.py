"""Models of the port: the dense decoder (config, layers, stages, facade)."""
