"""Test inputs: synthetic traces and the golden JAX outputs."""
