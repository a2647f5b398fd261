"""DB client (counterpart of ``examples/db-client``): a ball sim started as
an s10 recipe, a client that reads its live telemetry, runs SQL and EQL and
writes a component back."""
