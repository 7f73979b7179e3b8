"""Host environments of the port (numpy only), as in the JAX package's
envs/: the protocol, the fake backends and the factory."""
