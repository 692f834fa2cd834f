"""Device ops of the port: the exact histogram and the run-scan core."""
