"""Example models of the port, each a subpackage with relative imports:
three-body, the rocket, falcon9, the landing Monte Carlo, the drone and
the cube-sat."""
