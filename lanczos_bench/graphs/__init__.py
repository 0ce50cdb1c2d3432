"""Graph generators, one module a generator, found by the name a
configuration file gives; each has ``generate(config, seed)``."""
