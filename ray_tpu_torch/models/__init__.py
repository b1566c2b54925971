"""Models of the port: Llama configuration and parameters, the paged and
slot KV caches, and conversion of JAX parameter trees."""
