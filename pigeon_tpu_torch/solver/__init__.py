"""QP solver of the port: containers, Ruiz scaling and the lane solver."""
