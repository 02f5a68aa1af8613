"""fleet's topology and strategy."""
