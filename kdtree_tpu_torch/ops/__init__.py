"""Device operations of the port: generation, build, oracle, tiled query."""
