"""Example models of the port, each a subpackage with relative imports."""
