"""The distributed layer: a Cartesian mesh of shards driven by one process."""
