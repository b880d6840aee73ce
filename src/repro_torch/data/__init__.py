"""Trace sources of the port: SWF-like traces synthesized from Tables 2/3."""
