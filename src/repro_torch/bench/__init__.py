"""Figure scripts of the port."""
