"""Gang placement on a fleet: the eq.-(2) partition and BS-π admission."""
