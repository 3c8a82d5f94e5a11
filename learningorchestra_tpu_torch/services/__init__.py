"""REST services of the port (so far: the model builder's predict lane)."""
