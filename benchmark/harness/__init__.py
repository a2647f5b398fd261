"""The yardstick: loading the cells, running a window, reading the trace, the peaks."""
