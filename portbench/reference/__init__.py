"""Plain references the benchmark judges the port against (torch and
numpy only; nothing of the port, of JAX or of the JAX package)."""
