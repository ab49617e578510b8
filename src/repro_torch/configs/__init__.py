"""Model configurations of the port: copies of the JAX package's pure-data
config modules (``repro/configs``)."""
