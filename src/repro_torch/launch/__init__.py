"""Entry points of the port: ``sample`` (SA-Solver over a DiT backbone)."""
