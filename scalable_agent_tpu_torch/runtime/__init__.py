"""The fleet runtime of the port: env processes, actors, the inference
server, the trajectory buffer and prefetcher, and the actor fleet, as in
the JAX package's runtime/."""
