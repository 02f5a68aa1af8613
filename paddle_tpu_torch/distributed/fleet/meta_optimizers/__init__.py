"""fleet's dygraph meta-optimizers."""
