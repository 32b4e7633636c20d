"""Test harnesses of the port (the lockstep SPMD simulator)."""
