"""Graph-side host code of the port (copies of jax-importing reference
modules)."""
