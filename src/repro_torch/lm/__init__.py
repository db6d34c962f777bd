"""The LM substrate of the port: configuration and the dense model."""
