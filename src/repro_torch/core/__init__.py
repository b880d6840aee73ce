"""Workloads, the eq.-(2) partition, the engine registry and the sweeps."""
