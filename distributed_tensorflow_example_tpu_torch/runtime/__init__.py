"""Runtime helpers of the port (device choice)."""
