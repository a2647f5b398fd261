"""Video streaming into the telemetry database (counterpart of
``examples/video-stream``): a rolling-ball sim serves telemetry while a
producer pushes timestamped frames onto a message stream."""
