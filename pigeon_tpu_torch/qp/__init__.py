"""QP formulations of the port (the soft condensed coupled QP)."""
