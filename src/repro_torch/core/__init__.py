"""Core of the port: graph substrate, IR, code generator, executors."""
