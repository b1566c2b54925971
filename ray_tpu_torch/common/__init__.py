"""Host-side utilities of the port: the fault-point hook."""
