"""Example models of the port, each a subpackage with relative imports: the
counterparts of the JAX package's ``examples/`` directories (a dash in a
directory's name is an underscore here)."""
