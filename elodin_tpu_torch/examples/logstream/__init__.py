"""Log streaming (counterpart of ``examples/logstream``): structured
flight-software log messages into the telemetry database beside the ball
sim."""
