"""Neural-network layers of the LM substrate (the port's copy of
``repro.nn``: common primitives, self-attention, the dense MLP)."""
