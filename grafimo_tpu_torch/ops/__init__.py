"""Device ops of the port: the exact histogram, packed-window scoring, the
run-scan and window-scan cores, and copies of the reference's jax-free
host helpers."""
