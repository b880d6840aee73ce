"""Gang placement on a fleet: the eq.-(2) partition, BS-π admission and
the elastic rescale."""
